"""The user-facing classes: direct reconstruction (:mod:`.direct`,
``RecToolsDIR`` returning numpy arrays and ``RecToolsDIRTPU`` returning
tensors) and iterative reconstruction (:mod:`.iterative`,
``RecToolsIRTPU``)."""

from tomobar_tpu_torch.models.direct import RecToolsDIR, RecToolsDIRTPU
from tomobar_tpu_torch.models.iterative import RecToolsIRTPU

__all__ = ["RecToolsDIR", "RecToolsDIRTPU", "RecToolsIRTPU"]
