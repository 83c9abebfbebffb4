"""dipper-tpu: a distance-based phylogeny engine in JAX.

A from-scratch JAX re-design of the capabilities of TurakhiaLab/DIPPER
(a CUDA/C++ tool), run on an NVIDIA GPU:

- MinHash (Mash) sketching of unaligned DNA and sketch distances
- model-corrected distances from aligned FASTA (uncorrected, JC,
  Tajima-Nei, K2P, Tamura, Jin-Nei)
- precomputed lower-triangular PHYLIP distance matrices
- neighbor joining (N < 30K), incremental placement (exact and
  k-closest) for mid-size N, and a divide-and-conquer
  backbone/cluster pipeline for N >= 1M
- adding query tips to an existing backbone tree (--add)

Unlike the reference (a latency-oriented chain of tiny CUDA kernels with
serial device-side tree mutation), the tree builds are fixed-shape
jitted loops (`lax.fori_loop` / `lax.while_loop`), alignment statistics
are batched int8 matmuls, sketch intersections are one CUDA kernel
(native/mash_inter.cu) called through the XLA FFI, and `shard_map`
spreads work over several GPUs.
"""

__version__ = "0.1.0"

# 64-bit mode is required for the MinHash pipeline (MurmurHash3 is a
# 64-bit hash; sketch ordering must be bit-exact with the reference).
# We enable it at import; all performance-critical arrays pick their
# dtypes explicitly (f32/bf16/int32) so nothing silently runs in f64.
import jax as _jax

_jax.config.update("jax_enable_x64", True)

from dipper_tpu.utils.params import Param  # noqa: E402,F401
