"""pandepth_tpu_torch: the PyTorch and CUDA port of pandepth_tpu for
NVIDIA Hopper GPUs.

It runs the chr-mode path (``pandepth -i x.bam -o out``) end to end on
an H100: the shared jax-free half of ``pandepth_tpu`` decodes the BAM
into coverage events, and hand-written CUDA kernels
(``csrc/sweep_kernels.cu``) pack, scan and evaluate them on the card.
Importing the package imports neither torch nor jax.
"""

__version__ = "0.1.0"
