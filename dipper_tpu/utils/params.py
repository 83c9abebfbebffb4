"""Run configuration.

Mirrors the reference `Param` struct (src/mash_placement.cuh:16-32) plus
knobs of this implementation. Defaults follow the reference CLI defaults
(src/tree_generation.cu:192-231): k=15, sketchSize=1000,
distanceType=1 (uncorrected), input 'r', output 't'.
"""

from __future__ import annotations

import dataclasses


DIST_UNCORRECTED = 1
DIST_JUKESCANTOR = 2
DIST_TAJIMANEI = 3
DIST_KIMURA2P = 4
DIST_TAMURA = 5
DIST_JINNEI = 6

# Auto-mode thresholds (src/tree_generation.cu:247-248).
PLACEMENT_THRESHOLD = 30_000
DC_THRESHOLD = 1_000_000


@dataclasses.dataclass
class Param:
    kmer_size: int = 15
    sketch_size: int = 1000
    threshold: int = 1          # parsed but unused in the reference, kept for parity
    distance_type: int = DIST_UNCORRECTED
    in_format: str = "r"        # d | r | m
    out_format: str = "t"
    batch_size: int = 0         # D&C device batch size (= backbone size)
    backbone_size: int = 0      # D&C backbone size (= N // 20)

    # --- knobs with no reference equivalent ---
    # f32 is the default; f64 is the bit-parity path and is native on
    # the GPU (whether f32 and f64 trees agree at scale is ROADMAP R7).
    dtype: str = "float32"
    # seed for the input-order shuffle; the reference uses
    # mt19937(time(NULL)) (src/tree_generation.cu:343) which is
    # unreproducible — we default to a fixed seed and allow None for
    # "don't shuffle".
    shuffle_seed: int | None = 42
    # sketch-bank checkpointing (.npz); the reference persists nothing
    # (SURVEY §5) — the sketch bank is the natural resume unit.
    save_sketches: str | None = None
    load_sketches: str | None = None
    # placement tree-state checkpointing (.npz) + bounded-dispatch chunk
    # size (insertions per device dispatch; bounds one dispatch's size).
    save_state: str | None = None
    load_state: str | None = None
    state_chunk: int = 8192
    # pow2 prefix caps halve average per-insertion work but compile one
    # program per (cap bucket, N); disable when compile latency
    # dominates (a first run at a new N)
    prefix_caps: bool = True
    # shard work over the first `devices` local devices (mesh axis 'd');
    # the reference is strictly single-GPU (SURVEY §2.4)
    devices: int = 1
