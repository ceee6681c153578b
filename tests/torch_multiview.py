"""The folded-loss batch the tests share (`tests/test_torch_folded.py`,
`tests/torch_parallel_ranks.py`), on `profile_train.multiview_keys`'
geometry. Imports no JAX."""
import numpy as np

from dualpixelface_tpu_torch.profile_train import multiview_keys


def folded_batch(seed: int, b: int = 2, h: int = 12, w: int = 16, conf: bool = False) -> tuple[np.ndarray, dict]:
    """(pred_depth [b, 2, h, w], batch): depths in [800, 1200] but for a
    few pixels at -5 (their Z is clamped at 1e-3, their coordinates sent to
    2.0), a mask of ~75% of the pixels, the dual-pixel keys smoothL1 reads
    (abvalue given), `conf` in [0.5, 1] where asked."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(800, 1200, (b, 2, h, w)).astype(np.float32)
    pred[:, 0][rng.uniform(size=(b, h, w)) < 0.05] = -5.0
    depth = rng.uniform(800, 1200, (b, h, w)).astype(np.float32)
    ab = np.tile(np.array([[32.98, -26996.49]], np.float32), (b, 1))
    batch = {
        "mask": (rng.uniform(size=(b, h, w)) < 0.75).astype(np.float32),
        "depth": depth,
        "idepth": (depth.max() / depth).astype(np.float32),
        "disp": (ab[:, 1:2, None] / depth + ab[:, 0:1, None]).astype(np.float32),
        "abvalue": ab,
        **multiview_keys(rng, b, h, w),
    }
    if conf:
        batch["conf"] = rng.uniform(0.5, 1.0, (b, h, w)).astype(np.float32)
    return pred, batch
