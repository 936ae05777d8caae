from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   params_from_numpy,
                                                   save_checkpoint)

__all__ = ["load_checkpoint", "params_from_numpy", "save_checkpoint"]
