"""vgan_tpu_torch — the PyTorch / CUDA port of vgan_tpu.

A second package beside the JAX one (`vgan_tpu/`, the reference). It
runs HaploCart, euka and gam2prof on one NVIDIA H100. HaploCart's main
path:

  FASTQ -> minimizer seeding (C++) -> batched Smith-Waterman scoring
  (hand-written CUDA kernel, csrc/sw.cu) -> native finalize (C++) ->
  columnar filter/dedup/reconstruct -> f64 likelihood scorer (torch)
  -> argmax haplogroup.

euka maps the same way, scores each read under two per-base models
(f64 torch ops, pipelines/euka.py), detects taxa by bin coverage and
samples abundances with a Metropolis-Hastings chain on the device
(infer/abundance_mcmc.py).

Rules the package keeps:

* it imports torch and numpy, never jax or vgan_tpu (importing
  vgan_tpu turns on JAX's x64 mode, `vgan_tpu/__init__.py:29-31`, and
  the machine with the card has no jax); host modules are copied from
  vgan_tpu with their imports repointed, each naming its source on its
  first line;
* the device is explicit: every device function takes a `device` or
  tensors that already sit on one, and asking for CUDA where there is
  none raises (utils/device.py);
* importing the package changes no global dtype and picks no device;
* the native host library and the CUDA kernel are built from the
  checkout's sources at first use (_native.py); a failed build or
  load raises, nothing falls back.
"""

__version__ = "0.1.0"
