"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``portbench/workloads/<cell>.json``) names its configuration and
traffic; ``--seed`` makes the frames, the batches and the weights;
``--seconds`` is the measured window. With ``--trace 0`` the line's
metrics are the cell's end-to-end metrics of ``BENCHMARK.json``, with
``--trace 1`` its per-layer metrics, read from a profiled part of the
window by ``portbench/metrics/<metric>.py``. After the window the outputs
are checked against the plain reference (``portbench/harness/check.py``);
each number compared is printed beside its limit, last on standard error
and last in the line. The last line of standard output is one JSON object.

Without CUDA, or with fewer cards than the cell asks for, the run exits 2
and prints no result. So does a run whose process holds JAX or the JAX
package once the window has closed (exit 3).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "lstm_unet_tpu")
GIB = 2.0 ** 30


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``lstm_unet_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def end_to_end(cell, res) -> dict:
    values = {"setup_s": res["setup_s"], "peak_mem_gib": res["memory_peak_bytes"] / GIB}
    if cell.mode == "stream":
        values["stream_fps"] = res["frames"] / res["window_s"]
        values["frame_p95_ms"] = statistics.quantiles(res["latency_s"], n=20)[18] * 1e3
    else:
        tr = cell.traffic
        values["train_fps"] = res["steps"] * tr["batch"] * tr["unroll"] / res["window_s"]
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end()}


def per_layer(cell, res, root) -> dict:
    from portbench.harness.cell import metric_reader
    from portbench.harness.trace import TracedRun

    tr = cell.traffic
    lanes = tr.get("lanes", 1) * (4 if tr.get("inference", {}).get("tta") else 1)
    run = TracedRun(cell=cell, units=res.get("frames", res.get("steps")),
                    window_s=res["profiled_s"], trace=res["trace"], rate=res["rate"],
                    lanes=lanes, host_issue_s=res.get("host_issue_s", []),
                    postprocess_ms=res.get("postprocess_ms"))
    out = {}
    for m in cell.per_layer():
        v = metric_reader(m["name"], root)(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None, device=None, root: str = ROOT) -> int:
    args = parse(argv)
    import torch

    from portbench.harness import check, stream, train
    from portbench.harness.cell import load

    cell = load(args.workload, root)
    if device is None:
        chips = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    seed = args.seed & (2 ** 63 - 1)
    driver = stream if cell.mode == "stream" else train
    res = driver.run(cell, seed, args.seconds, bool(args.trace), device, T0)

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} after the window", file=sys.stderr)
        return 3
    verdict = check.decide(res["numbers"], cell.workload["limits"])
    line = {"correct": verdict["correct"],
            "attempted": res.get("frames", res.get("steps")),
            "failed": 0,
            "metrics": per_layer(cell, res, root) if args.trace else end_to_end(cell, res)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.workload["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        dev.update(busy_s=res["trace"].busy_s, window_s=res["profiled_s"])
    line["device"] = dev
    if args.trace:
        line["breakdown"] = {"device_ops": res["trace"].device_ops,
                             "idle_gaps": res["trace"].idle_gaps}
    line["info"] = {k: res[k] for k in ("instances", "rounds_per_frame", "postprocess_ms",
                                        "latency_ms")
                    if k in res}
    line["info"]["not_compared"] = {k: v for k, v in res["numbers"].items()
                                    if k not in cell.workload["limits"]}
    line["check"] = {k: [v["value"], v["limit"]] for k, v in verdict["numbers"].items()}
    check.report(verdict)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
