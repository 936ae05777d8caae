from recbole_gnn_tpu_torch.config.config import Config

__all__ = ["Config"]
