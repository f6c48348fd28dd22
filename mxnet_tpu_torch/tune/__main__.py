"""Offline schedule sweep of the hand-written kernels (counterpart of
``tools/tune_kernels.py``, the same flags and report).

Sweeps B1-B3's tiles (``fused_fwd``, ``fused_wgrad``, ``fused_dgrad``) at
one conv shape and flash attention's ``(block_q, block_k)`` at one
attention shape and at the generate-serving decode shape, times the
legal candidates round robin on the card (event and device time; the
winner is the least device time) and commits each winner into the
schedule table (``MXNET_TPU_TUNE_TABLE`` /
``~/.cache/mxnet_tpu/schedule_table.json``, backend ``"cuda"``). The
kernel entry points then pick the winners up when they are called.

    python -m mxnet_tpu_torch.tune                  # on the card
    python -m mxnet_tpu_torch.tune --compare        # exhaustive, refit,
                                                    # then ranked
    python -m mxnet_tpu_torch.tune --cpu            # the plain versions

The card's defaults are the JAX tool's on-device shapes: conv 64 x 14 x 14
x 256 -> 256 3x3, flash 8 x 8 x 1024, D 128, causal, bf16, and the decode
shape at 8 slots. With ``--cpu`` the plain versions run under backend
``"cpu"`` at a small shape (conv 2 x 8 x 8 x 128, flash 2 x 2 x 128, D
64): that checks the mechanics (pruning, commits, cache hits), not the
card's tiles. A re-run with a tuned table is a pure cache hit; ``--force``
re-searches. The last line of standard output is one JSON report
(``{"tune": {key: report}, "backend": ..., "table": ..., ...}``).
"""
import argparse
import json
import sys


def _run_one(sweep_fn, kw, args):
    """One sweep, honoring --compare: the exhaustive sweep first (it banks
    every timing), a cost-model refit from the table, then the ranked
    sweep (forced), with both wall times side by side. The better measured
    winner stays committed."""
    from .. import tune

    if not args.compare:
        return sweep_fn(**kw)
    exh = sweep_fn(**dict(kw, ranked=False, force=True))
    tune.fit_cost_model()   # the ranked pass learns from the exhaustive one
    rep = sweep_fn(**dict(kw, ranked=True, force=True))
    rep["exhaustive"] = {
        "n_timed": exh["n_timed"], "wall_s": exh.get("wall_s"),
        "winner_ms": exh["winner"]["ms_per_iter"],
        "winner_schedule": exh["winner"]["schedule"],
    }
    if exh["winner"]["ms_per_iter"]:
        rep["winner_delta_pct"] = round(
            (rep["winner"]["ms_per_iter"] - exh["winner"]["ms_per_iter"])
            / exh["winner"]["ms_per_iter"] * 100, 2)
        if rep["winner_delta_pct"] > 0 \
                and rep["winner"]["schedule"] != exh["winner"]["schedule"]:
            # without timings: record() keeps the bank as it is
            winner = {k: v for k, v in exh["winner"].items()
                      if k != "timings"}
            tune.get_table().record(exh["kernel"], tuple(exh["shape"]),
                                    exh["dtype"], exh["backend"], winner)
            rep["recommitted_exhaustive_winner"] = True
    return rep


def _line(rep):
    if rep["cache_hit"]:
        return "%-56s cache hit  schedule=%s" % (rep["key"],
                                                 rep["winner"]["schedule"])
    w = rep["winner"]
    rk = rep.get("ranker") or {}
    extra = ""
    if rk.get("mode") == "ranked":
        extra = "  ranked(top %d, skipped %d)" % (
            rk.get("topk", 0), rep.get("n_skipped_ranked", 0))
    elif rk.get("abstained"):
        extra = "  ranker abstained (%s)" % rk.get("reason", "")
    if "winner_delta_pct" in rep:
        extra += "  delta_vs_exhaustive=%+.2f%%" % rep["winner_delta_pct"]
    ms = "%.4f ms (default %.4f" % (w["ms_per_iter"],
                                    w["default_ms_per_iter"])
    if "event_ms_per_iter" in w:
        ms = "device %.4f / event %.4f ms (default %.4f / %.4f" % (
            w["ms_per_iter"], w["event_ms_per_iter"],
            w["default_ms_per_iter"], w["default_event_ms_per_iter"])
    return ("%-56s timed %d/%d (pruned %d)  winner=%s  %s, %.3fx)  %.1fs%s"
            % (rep["key"], rep["n_timed"], rep["n_candidates"],
               rep["n_pruned"], w["schedule"], ms, w["speedup_vs_default"],
               rep.get("wall_s") or 0.0, extra))


def run_sweeps(args, strict=True):
    from .. import profiler, tune

    device = "cpu" if args.cpu else "cuda"
    common = dict(budget=args.budget, repeats=args.repeats,
                  iters=args.iters, target_sec=args.target_sec,
                  min_iters=args.min_iters, device=device, force=args.force,
                  ranked=args.ranked, topk=args.topk)
    unsweepable, reports = {}, {}
    x_shape = (args.batch, args.hw, args.hw, args.ci)
    w_shape = (3, 3, args.ci, args.co)
    for kernel in args.kernels.split(","):
        if kernel in tune.FUSED_KINDS:
            reps = [_run_one(tune.sweep_fused,
                             dict(common, kernel=kernel, x_shape=x_shape,
                                  w_shape=w_shape, stride=args.stride,
                                  dtype=args.dtype), args)]
        elif kernel == "flash_attention":
            reps = [_run_one(tune.sweep_flash,
                             dict(common, b=args.flash_batch, h=args.heads,
                                  seq_q=args.seq, seq_k=args.seq,
                                  d=args.head_dim, causal=args.causal,
                                  dtype=args.flash_dtype), args)]
            if args.decode:
                # the generate-serving decode shape: one query a slot over
                # the whole cached window, causal 0, the key of
                # models.transformer.decode_schedule_shape
                reps.append(_run_one(
                    tune.sweep_flash,
                    dict(common, b=args.decode_slots, h=args.heads,
                         seq_q=1, seq_k=args.seq, d=args.head_dim,
                         causal=False, dtype=args.flash_dtype), args))
        elif not strict:
            owners = sorted(r for r, ks in tune.rule_kernels().items()
                            if kernel in ks)
            unsweepable[kernel] = {"named_by_rules": owners}
            print("%-56s UNSWEEPABLE (named by rules %s; no sweep recipe)"
                  % (kernel, owners))
            continue
        else:
            raise SystemExit("unknown kernel %r (choose from %s)"
                             % (kernel, ",".join(tune.sweepable_kernels())))
        for rep in reps:
            reports[rep["key"]] = rep
            print(_line(rep))
    report = {"tune": reports, "backend": "cpu" if args.cpu else "cuda",
              "table": tune.default_table_path(),
              "model": tune.default_model_path(),
              "rule_kernels": tune.rule_kernels(),
              "tuning_stats": profiler.tuning_stats()}
    if unsweepable:
        report["unsweepable"] = unsweepable
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.tune")
    ap.add_argument("--kernels", default=None,
                    help="comma list: fused_fwd,fused_wgrad,fused_dgrad,"
                         "flash_attention (default: all)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--hw", type=int, default=None,
                    help="conv spatial size (card default: 14)")
    ap.add_argument("--ci", type=int, default=None)
    ap.add_argument("--co", type=int, default=None)
    ap.add_argument("--stride", type=int, default=1, choices=(1, 2))
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--flash-batch", type=int, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--head-dim", type=int, default=None)
    ap.add_argument("--no-causal", dest="causal", action="store_false",
                    help="sweep non-causal attention; causal is part of "
                         "the table key, and the transformer consults with "
                         "causal=True")
    ap.set_defaults(causal=True)
    ap.add_argument("--flash-dtype", default="bfloat16",
                    help="flash sweep dtype; the table key holds it, so it "
                         "must match the caller's compute dtype")
    ap.add_argument("--no-decode", dest="decode", action="store_false",
                    help="skip the decode-shape flash sweep (seq_q=1, "
                         "causal=0)")
    ap.set_defaults(decode=True)
    ap.add_argument("--decode-slots", type=int, default=None,
                    help="batch dim of the decode sweep (default: "
                         "MXNET_GENERATE_SLOTS's default, 8)")
    ap.add_argument("--ranked", dest="ranked", action="store_true",
                    default=None,
                    help="force ranked sweeps (default: MXNET_TUNE_RANKER)")
    ap.add_argument("--no-ranked", dest="ranked", action="store_false",
                    help="pin the exhaustive sweep")
    ap.add_argument("--topk", type=int, default=None,
                    help="ranked-mode candidates to time (default: "
                         "MXNET_TUNE_TOPK)")
    ap.add_argument("--compare", action="store_true",
                    help="the exhaustive sweep, a model refit, then the "
                         "ranked sweep, reported side by side per key")
    ap.add_argument("--budget", type=int, default=8,
                    help="max timed programs a kernel, the default "
                         "included")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--iters", type=int, default=None,
                    help="calls a timed program (default: calibrated to "
                         "--target-sec, at most 100 on the card)")
    ap.add_argument("--target-sec", type=float, default=None)
    ap.add_argument("--min-iters", type=int, default=None)
    ap.add_argument("--table", default=None,
                    help="table path (overrides MXNET_TPU_TUNE_TABLE)")
    ap.add_argument("--force", action="store_true",
                    help="re-search keys already in the table")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the CPU (backend cpu)")
    return ap.parse_args(argv)


def run(argv=None):
    """Parse ``argv``, apply the device's defaults and run the sweeps;
    returns the report (what :func:`main` prints as its last line)."""
    import os

    import torch

    args = parse_args(argv)
    if args.table:
        os.environ["MXNET_TPU_TUNE_TABLE"] = args.table
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --cpu to time the plain "
                         "versions")
    card = not args.cpu
    strict = args.kernels is not None
    if args.kernels is None:
        from .. import tune

        args.kernels = ",".join(tune.sweepable_kernels())
    defaults = dict(batch=(64, 2), hw=(14, 8), ci=(256, 128),
                    flash_batch=(8, 2), heads=(8, 2), seq=(1024, 128),
                    head_dim=(128, 64), decode_slots=(8, 4),
                    target_sec=(0.05, 0.05), min_iters=(10, 2))
    for name, (on_card, on_cpu) in defaults.items():
        if getattr(args, name) is None:
            setattr(args, name, on_card if card else on_cpu)
    if args.co is None:
        args.co = args.ci
    print("device: %s  conv: batch=%d hw=%d ci=%d co=%d stride=%d  flash: "
          "b=%d h=%d seq=%d d=%d  budget=%d repeats=%d"
          % ("cuda" if card else "cpu", args.batch, args.hw, args.ci,
             args.co, args.stride, args.flash_batch, args.heads, args.seq,
             args.head_dim, args.budget, args.repeats))
    return run_sweeps(args, strict=strict)


def main(argv=None):
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
