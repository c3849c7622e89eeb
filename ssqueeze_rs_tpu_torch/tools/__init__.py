"""The TPU probes of ``tools/`` on the H100: hand-written kernels that ask
this card what the Pallas probes asked the TPU.

  ablate_cwt_kernel     probes P1-P3 (``csrc/ablate_cwt.cu``): kernel D's
                        launch pair with parts taken out, its copy floor
                        (TMA bulk copies), and its first launch fed by TMA
  cwt_kernel_probe      the coarse split of D (dma / glue / full) as
                        modes of P1
  ablate_reassign       probe P4 (``csrc/ablate_reassign.cu``): kernels B
                        and B' (their own scatter) under ablation flags,
                        and the row walk they ran before
  bench_reassign_batch  B' over a batch: batch grid, 1-D grid, or one
                        flat call (P4's grid modes)
  mxu_rate_probe        J5 (``csrc/rate_probe.cu``): the tensor-core rate
                        by shape in bf16, TF32 and 3xTF32, independent
                        chains (--chains), the shared-memory rate
  mxu_probe             J6 (``csrc/mxu_probe.cu``): the dots and operand
                        builds around a digit-split one-hot product
  mxu_probe2            J6's second round (GRID 128, the B build in full)
  dma_overlap_probe     J7 (``csrc/dma_overlap.cu``): a bulk copy racing a
                        serial bf16 chain
  grid_slope_probe      J8 (``csrc/grid_slope.cu``): the cost per block
                        and per launch of a trivial kernel
  sass_compare          the path kernels' machine code built from two
                        source trees, function by function (no card)

Each runs as ``python -m ssqueeze_rs_tpu_torch.tools.<name> [K]
[--device cpu]``: on the CUDA device by default (no device raises), one
line per variant with its median ms over K runs (CUDA events, after a
warm-up; J5-J8 also the host wall ms a call over K back-to-back calls),
its bound and the card's name and power limit; `--device cpu` runs the
plain versions at a small shape.
"""
