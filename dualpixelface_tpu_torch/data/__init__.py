"""Host-side data pipeline of the PyTorch port (counterpart of
`dualpixelface_tpu/data/`): the loader registry (`loader_selector`), the
per-dataset loaders (`FaceDP/`, the on-disk RCV benchmark reader;
`SyntheticDP/`, its in-memory twin), the preprocessing (`preprocess/`) and
the batches (`pipeline.py`, a torch DataLoader).
"""
from dualpixelface_tpu_torch.data.loader_selector import loader_selector, register_loader

__all__ = ["loader_selector", "register_loader"]
