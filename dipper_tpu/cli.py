"""dipper-tpu command line interface.

Flag surface mirrors the reference CLI (src/tree_generation.cu:33-99):

  -i/--input-format {d,r,m}   PHYLIP matrix | raw FASTA | aligned FASTA
  -I/--input-file PATH
  -O/--output-file PATH
  -o/--output-format {t}
  -m/--algorithm {0,1,2,3}    auto | placement | NJ | divide-and-conquer
  -p/--placement-mode {0,1}   exact | k-closest
  -k/--kmer-size INT          (2..15, default 15)
  -s/--sketch-size INT        (default 1000)
  -d/--distance-type {1..6}
  -a/--add  -t/--input-tree PATH

Reference quirks intentionally preserved:
- `-p` is parsed but the effective placement mode comes from the
  `-m/--algorithm` value (tree_generation.cu:222-224): auto mode uses
  exact placement... actually: placemode defaults to "1" (k-closest)
  and is overwritten by the -m value when -m is given. So `-m 0` =>
  exact placement, `-m 1`/no -m => k-closest.
- distance type default 1 (uncorrected) in code even though docs say JC.

Additions: --precision {f32,f64}, --seed INT (the
reference shuffles input order with time(NULL); we default to a fixed
seed for reproducibility; --seed -1 disables shuffling).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dipper-tpu",
        description="distance-based phylogenetic tree builder (JAX)",
    )
    p.add_argument("-i", "--input-format", required=True, choices=["d", "r", "m"])
    p.add_argument("-I", "--input-file", required=True)
    p.add_argument("-O", "--output-file", required=True)
    p.add_argument("-o", "--output-format", default="t", choices=["t", "d"],
                   help="t = Newick tree; d = PHYLIP distance matrix "
                        "(the reference lists this as 'coming soon')")
    p.add_argument("-m", "--algorithm", default=None, choices=["0", "1", "2", "3"])
    p.add_argument("-p", "--placement-mode", default=None, choices=["0", "1"])
    p.add_argument("-k", "--kmer-size", type=int, default=15)
    p.add_argument("-s", "--sketch-size", type=int, default=1000)
    p.add_argument("-d", "--distance-type", type=int, default=1, choices=range(1, 7))
    p.add_argument("-a", "--add", action="store_true")
    p.add_argument("-t", "--input-tree", default=None)
    p.add_argument("--precision", default="f32", choices=["f32", "f64"])
    p.add_argument("--seed", type=int, default=42,
                   help="input shuffle seed; -1 = keep input order")
    p.add_argument("--save-sketches", default=None, metavar="NPZ",
                   help="write the MinHash sketch bank to an .npz and "
                        "continue (checkpoint; reference has none)")
    p.add_argument("--load-sketches", default=None, metavar="NPZ",
                   help="resume from a saved sketch bank instead of "
                        "re-sketching (-i r only)")
    p.add_argument("--save-state", default=None, metavar="NPZ",
                   help="checkpoint the placement tree state every "
                        "--state-chunk insertions (reference persists "
                        "nothing)")
    p.add_argument("--load-state", default=None, metavar="NPZ",
                   help="resume a placement build from a tree-state "
                        "checkpoint")
    p.add_argument("--state-chunk", type=int, default=8192,
                   help="insertions per device dispatch (bounds single-"
                        "execution length; checkpoint granularity)")
    p.add_argument("--no-prefix-caps", action="store_true",
                   help="disable pow2 prefix-cap buckets (one XLA "
                        "program instead of one per bucket; ~2x the "
                        "steady per-insertion work but far fewer "
                        "compiles — wins on first runs at a new N)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the build to DIR")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="shard work over the first N local devices "
                        "(row-sharded NJ Q-scan; data-parallel D&C "
                        "cluster builds). 1 = single chip (default)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host: jax.distributed coordinator "
                        "address (or set DIPPER_COORDINATOR); every "
                        "participating host runs the same command "
                        "with its own --process-id")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None) -> int:
    import os

    import jax

    from dipper_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    args = build_parser().parse_args(argv)
    if args.add and not args.input_tree:
        print("ERROR: --input-tree/-t is required with --add", file=sys.stderr)
        return 1
    for path in filter(None, [args.input_file, args.input_tree]):
        if not os.path.exists(path):
            print(f"ERROR: cannot open file: {path}", file=sys.stderr)
            return 1

    from dipper_tpu.parallel.distributed import init_distributed

    proc_id, proc_count = init_distributed(
        args.coordinator, args.num_processes, args.process_id)
    if proc_count > 1:
        print(f"Joined distributed runtime: process {proc_id}/{proc_count},"
              f" {len(jax.devices())} global devices", file=sys.stderr)

    from dipper_tpu.utils.params import Param, PLACEMENT_THRESHOLD, DC_THRESHOLD

    algo = args.algorithm or "0"
    # reference quirk: placemode is read from the algorithm flag
    placemode = args.algorithm if args.algorithm is not None else "1"

    params = Param(
        kmer_size=args.kmer_size,
        sketch_size=args.sketch_size,
        distance_type=args.distance_type,
        in_format=args.input_format,
        out_format=args.output_format,
        dtype="float64" if args.precision == "f64" else "float32",
        shuffle_seed=None if args.seed == -1 else args.seed,
        save_sketches=args.save_sketches,
        load_sketches=args.load_sketches,
        save_state=args.save_state,
        load_state=args.load_state,
        state_chunk=args.state_chunk,
        prefix_caps=not args.no_prefix_caps,
        devices=args.devices,
    )

    from dipper_tpu.driver import run_pipeline

    t0 = time.time()
    if args.profile:
        import jax.profiler

        jax.profiler.start_trace(args.profile)
    from dipper_tpu.io.errors import InputFormatError

    try:
        run_pipeline(params, algo, placemode, args)
    except InputFormatError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    finally:
        if args.profile:
            import jax.profiler

            jax.profiler.stop_trace()
    print(f"Tree Created in: {int((time.time() - t0) * 1000)} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
