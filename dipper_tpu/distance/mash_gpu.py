"""The CUDA mash intersection kernel (native/mash_inter.cu) as a JAX
operation.

The shared library is built by native/Makefile (`make -C native
libmash_inter.so`, nvcc for sm_90a) on first use in a process whose
default backend is the GPU, and registered as an XLA FFI target for
CUDA. A build or load failure raises: there is no fallback on a GPU.
distance/mash.py:mash_pairwise_inter decides where the kernel runs.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_SRC = os.path.join(_NATIVE_DIR, "mash_inter.cu")
_LIB = os.path.join(_NATIVE_DIR, "libmash_inter.so")
_TARGET = "dipper_mash_inter"


@functools.cache
def register_kernel() -> None:
    """Build the library if it is missing or older than its source, and
    register it for CUDA. Raises RuntimeError with the compiler's
    output if the build fails."""
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
        r = subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"PYTHON={sys.executable}",
             "libmash_inter.so"],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"building {_LIB} failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.cdll.LoadLibrary(_LIB)
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.DipperMashInter), platform="CUDA")


def mash_inter_gpu(bank_ranks, query_ranks, *, sketch_size: int):
    """int32 ranks bank [..., N, M] x queries [..., Q, M] -> int32
    intersection counts [..., Q, N], equal to
    mash._merged_inter_count's. Rows ascend; pad keys (pad_ranks) sort
    after every real rank."""
    if jax.default_backend() == "gpu":
        register_kernel()
    shape = query_ranks.shape[:-1] + (bank_ranks.shape[-2],)
    out = jax.ShapeDtypeStruct(shape, jnp.int32)
    aval = jax.typeof(query_ranks)
    vma = jax.typeof(bank_ranks).vma | aval.vma
    if vma:  # inside shard_map the result varies over the inputs' axes
        out = jax.ShapeDtypeStruct(
            shape, jnp.int32, vma=vma,
            sharding=jax.sharding.NamedSharding(aval.sharding.mesh,
                                                jax.sharding.PartitionSpec()))
    return jax.ffi.ffi_call(_TARGET, out, vmap_method="broadcast_all")(
        bank_ranks.astype(jnp.int32), query_ranks.astype(jnp.int32),
        sketch_size=np.int64(sketch_size))
