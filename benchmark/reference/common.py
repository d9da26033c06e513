"""Precision helpers of the plain reference."""

from __future__ import annotations

import torch

# the reference's float32 matrix products run in float32, not TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rounder(prec: str):
    """The rounding each stage's result goes through: none in float32, to
    bfloat16 and back in the control."""
    if prec == "fp32":
        return lambda x: x
    if prec == "bf16":
        def to_bf16(x):
            if x.is_complex():
                return torch.complex(x.real.to(torch.bfloat16).float(), x.imag.to(torch.bfloat16).float())
            return x.to(torch.bfloat16).to(x.dtype)
        return to_bf16
    raise ValueError(f"unknown precision {prec!r}")


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, in float64."""
    got, ref = got.double(), ref.double().to(got.device)
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
