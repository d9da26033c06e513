"""The operators under the models: the projector pair (:mod:`.projector`
and its kernel wrappers :mod:`.projector_kernels`), FBP's filters
(:mod:`.filters`, :mod:`.fft_real`, :mod:`.fft_kernels`), FOURIER_INV's
USFFT (:mod:`.usfft`, :mod:`.usfft_kernels`) and the PD-TV prox
(:mod:`.pd_tv`).  Each kernel wrapper launches its CUDA kernel on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor."""
