"""Benchmarks of tomobar_tpu_torch on the card: timing and quality helpers
(:mod:`.harness`), the flagship's roofline breakdown (:mod:`.breakdown`),
FOURIER_INV's stages (:mod:`.fourier_breakdown`), time-to-RMSE at the
north-star shape (:mod:`.northstar`) and the sharded layer's collectives
(:mod:`.scaling`).  Counterpart of ``tomobar_tpu/bench/``; each module runs
as ``python -m tomobar_tpu_torch.bench.<module>``."""
