from tomobar_tpu_torch.models.direct import RecToolsDIR, RecToolsDIRTPU
from tomobar_tpu_torch.models.iterative import RecToolsIRTPU

__all__ = ["RecToolsDIR", "RecToolsDIRTPU", "RecToolsIRTPU"]
