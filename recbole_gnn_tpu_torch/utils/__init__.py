from recbole_gnn_tpu_torch.utils.enums import ModelType, InputType
from recbole_gnn_tpu_torch.utils.seed import init_seed
from recbole_gnn_tpu_torch.utils.logging import init_logger, get_logger

__all__ = ["ModelType", "InputType", "init_seed", "init_logger", "get_logger"]
