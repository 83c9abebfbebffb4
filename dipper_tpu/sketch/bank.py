"""Sketch-bank construction with checkpoint/resume.

The reference persists nothing between runs (SURVEY §5); its D&C host
bank h_hashList is the natural checkpoint unit, realized here as an
.npz of the [N, sketch_size] u64 bank keyed by (k, sketch_size)."""

from __future__ import annotations

import sys

import numpy as np

from dipper_tpu.utils.params import Param


def get_sketch_bank(seqs, params: Param, as_device: bool = False):
    """Returns the [N, sketch_size] u64 sketch bank. With
    `as_device=True` (and no checkpoint I/O requested) the bank stays
    device-resident — callers that immediately rank-compress skip two
    host-device copies."""
    if as_device and not params.load_sketches and not params.save_sketches:
        from dipper_tpu.sketch.minhash import sketch_sequences

        return sketch_sequences(seqs, params.kmer_size, params.sketch_size,
                                as_device=True)
    if params.load_sketches:
        data = np.load(params.load_sketches)
        sk = data["sketches"]
        if (int(data["kmer_size"]) != params.kmer_size
                or int(data["sketch_size"]) != params.sketch_size
                or sk.shape[0] != len(seqs)):
            raise SystemExit(
                f"sketch bank mismatch: file has N={sk.shape[0]} "
                f"k={int(data['kmer_size'])} s={int(data['sketch_size'])}, "
                f"run wants N={len(seqs)} k={params.kmer_size} "
                f"s={params.sketch_size}")
        print(f"Loaded sketch bank from {params.load_sketches}",
              file=sys.stderr)
    else:
        # host-resident bank: the native sketcher avoids the D2H pull
        # of a device-computed bank (bit-identical; DIPPER_NATIVE_SKETCH=0
        # forces the device path)
        from dipper_tpu.sketch.native import sketch_sequences_native

        sk = sketch_sequences_native(seqs, params.kmer_size,
                                     params.sketch_size)
        if sk is None:
            from dipper_tpu.sketch.minhash import sketch_sequences

            sk = sketch_sequences(seqs, params.kmer_size,
                                  params.sketch_size)
    if params.save_sketches:
        np.savez_compressed(
            params.save_sketches, sketches=sk,
            kmer_size=params.kmer_size, sketch_size=params.sketch_size)
        print(f"Saved sketch bank to {params.save_sketches}",
              file=sys.stderr)
    return sk
