"""The face-parsing BiSeNet and the demo-mask tool around it (not a
registered model)."""
from dualpixelface_tpu_torch.models.face_seg.evaluate import FaceMaskEstimator  # noqa: F401
from dualpixelface_tpu_torch.models.face_seg.model import BiSeNet  # noqa: F401
