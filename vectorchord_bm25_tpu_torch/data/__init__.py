from .beir import BeirDataset, load_beir
from .metrics import ndcg_at_k, recall_at_k
from .synthetic import generate_beir_like

__all__ = [
    "BeirDataset",
    "load_beir",
    "ndcg_at_k",
    "recall_at_k",
    "generate_beir_like",
]
