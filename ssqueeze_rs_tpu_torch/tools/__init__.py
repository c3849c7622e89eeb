"""The TPU probes of ``tools/`` on the H100: hand-written kernels that ask
this card what the Pallas probes asked the TPU.

  ablate_cwt_kernel     probes P1-P3 (``csrc/ablate_cwt.cu``): kernel D
                        with parts taken out, its copy floor, and its
                        first launch with explicit asynchronous staging
  cwt_kernel_probe      the coarse split of D (dma / glue / full) as
                        modes of P1
  ablate_reassign       probe P4 (``csrc/ablate_reassign.cu``): kernel B'
                        with parts taken out
  bench_reassign_batch  B' over a batch: batch grid, 1-D grid, or one
                        flat call (P4's grid modes)

Each runs as ``python -m ssqueeze_rs_tpu_torch.tools.<name> [K]
[--device cpu]``: on the CUDA device by default (no device raises), one
line per variant with its median ms over K runs (CUDA events, after a
warm-up), its bound and the card's name and power limit; `--device cpu`
runs the plain versions at a small shape.
"""
