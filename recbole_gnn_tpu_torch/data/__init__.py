from recbole_gnn_tpu_torch.data.dataset import Dataset, GeneralGraphDataset

__all__ = ["Dataset", "GeneralGraphDataset"]
