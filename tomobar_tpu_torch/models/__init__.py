from tomobar_tpu_torch.models.iterative import RecToolsIRTPU

__all__ = ["RecToolsIRTPU"]
