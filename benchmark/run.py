"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: set up (inputs and weights from the seed, the
program's trainer built and driven through its first calls), measure for
``--seconds`` (whole calls of the entry; with ``--trace 1`` under
``torch.profiler``), free the program's state, compare what it computed
with the plain reference, and print one JSON line as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, ``window`` (the window's
work, its unit, seconds and calls), and last ``compared``, each
number that decided ``correct`` beside its limit (also the last lines of
standard error).

A cell of more than one chip runs as that many ranks, one process a card
(``launch``): this command again with ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, meeting over TCP on a free port of
``localhost``. Every rank sets up its own side of the entry and runs the
window, whose calls end together (rank 0 decides); work and failed steps
are summed over the ranks, the memory peak is the fullest card's, and the
device's busy time the ranks' mean. Rank 0 compares and prints.

Exit codes: 0 with a result; 2 for a bad argument or cell; 3 without the
cards the cell needs; 4 when JAX, flax, optax or the JAX package is loaded
after the window. No result is printed unless the code is 0.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "instance_nerf_tpu")
# the build and kernel caches, at fixed paths inside the checkout, so that
# only a cell's first run in a checkout compiles
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def parse(argv):
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's, flax's, optax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_reader(name: str):
    from benchmark.harness.manifest import metric_path

    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ranks:
    """This process's place among the cell's ranks (one rank: no group)."""

    def __init__(self, device):
        self.world = int(os.environ.get("WORLD_SIZE", "1"))
        self.rank = int(os.environ.get("RANK", "0"))
        self.device = device
        if self.world > 1:
            import torch.distributed as dist

            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                rank=self.rank, world_size=self.world)

    def reduce(self, values, op: str):
        """``values`` (numbers) reduced over the ranks by ``op`` ("sum" or
        "max"); as they are with one rank."""
        if self.world == 1:
            return list(values)
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        return t.tolist()

    def stop(self, done: bool) -> bool:
        """Rank 0's ``done``, on every rank."""
        if self.world == 1:
            return done
        import torch
        import torch.distributed as dist

        t = torch.tensor([1 if done else 0], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def close(self) -> None:
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()
            dist.destroy_process_group()


def measure(sess, seconds: float, traced: bool, ranks: Ranks):
    """Whole calls until one ends at or past ``seconds`` (rank 0's clock):
    (work, calls, window seconds, failed steps, the reduced trace or None)."""
    import torch
    from torch.profiler import record_function

    from benchmark.harness import trace

    prof = trace.profiler() if traced else nullcontext()
    work = calls = failed = 0
    with prof:
        with record_function(trace.WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                with record_function(trace.CALL_SPAN):
                    done, ok = sess.call()
                work += done
                calls += 1
                failed += 0 if ok else sess.steps_per_call
                if ranks.stop(time.perf_counter() - t0 >= seconds):
                    break
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    reduced = trace.reduce_profile(prof, (sess.prefix + ".", "bench.")) if traced else None
    return work, calls, window_s, failed, reduced


def run(args, cell, device_override=None) -> dict:
    """One run of ``cell``; returns the result line's object.
    ``device_override`` runs it elsewhere than the first card (the CPU dry
    runs of ``benchmark/tests``, which report no device metric)."""
    import torch

    from benchmark.harness import compare, device, readers

    rank = int(os.environ.get("RANK", "0"))
    dev = device_override or torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ranks = Ranks(dev)
    ctx = SimpleNamespace(seed=args.seed, device=dev, config=cell.config, traffic=cell.traffic,
                          workload=cell.workload, rank=ranks.rank, world=ranks.world)
    entry = importlib.import_module(f"benchmark.entries.{cell.workload['entry']}")
    sess = entry.setup(ctx)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0
    work, calls, window_s, failed, reduced = measure(sess, args.seconds, bool(args.trace), ranks)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    peak = max(setup_peak, window_peak) if on_card else 0
    work, failed = (int(v) for v in ranks.reduce([work, failed], "sum"))
    window_peak, peak = (int(v) for v in ranks.reduce([window_peak, peak], "max"))
    if reduced is not None:  # the device's busy time: the ranks' mean
        busy, win = ranks.reduce([reduced["busy_s"], reduced["window_s"]], "sum")
        reduced.update(busy_s=busy / ranks.world, window_s=win / ranks.world)
    record = SimpleNamespace(
        config=cell.config, traffic=cell.traffic, prefix=sess.prefix, work=work,
        work_unit=sess.work_unit, window_s=window_s, setup_s=setup_s, calls=calls,
        steps=calls * sess.steps_per_call, flops_per_call=sess.flops_per_call,
        trace=reduced, window_peak_bytes=window_peak, peak_bytes=peak)
    readings = sess.readings() if ranks.rank == 0 else None
    sess.close()
    del sess
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if ranks.rank != 0:
        ranks.close()
        return None
    seen = readings.pop("seen", None)
    ref_mod = importlib.import_module(f"benchmark.reference.{cell.config_name}")
    t_ref = time.perf_counter()
    ref = ref_mod.readings(cell.config, cell.traffic, args.seed, dev, seen=seen)
    print(f"benchmark: the reference took {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    numbers = compare.gaps(readings, ref)
    correct, rows = compare.verdict(numbers, cell.workload["limits"])
    specs = cell.per_layer if args.trace else cell.end_to_end
    if not on_card:  # a CPU dry run writes no number under a device metric's name
        specs = [m for m in specs if m["source"] not in ("device_trace", "program_counter")]
    metrics = {}
    for m in specs:
        v = load_reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": record.steps, "failed": failed,
              "metrics": metrics,
              "device": device.info(cell.chips, peak) if on_card else {"platform": "cpu"}}
    if reduced is not None:
        result["device"].update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        top = sorted(reduced["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[k, v[0]] for k, v in top],
                               "idle_gaps": reduced["idle_gaps"][:10]}
        result["trace"] = {"steps_run": record.steps,
                           "step_spans_seen": readers.steps_seen(record) or 0}
    # the window's work and seconds as measured, whatever the line's metrics
    result["window"] = {"work": work, "unit": record.work_unit, "seconds": window_s,
                        "calls": calls}
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    ranks.close()
    return result


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(cmd: list, world: int) -> int:
    """``cmd`` as ``world`` ranks, one process each, meeting on a free port
    of ``localhost``; only rank 0 writes to standard output. Waits for every
    rank; where one fails, stops the others. Returns the first non-zero
    exit code, else 0."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=None if r == 0 else subprocess.DEVNULL))
    rc, alive = 0, set(range(world))
    while alive:
        for r in sorted(alive):
            code = procs[r].poll()
            if code is None:
                continue
            alive.discard(r)
            if code != 0 and rc == 0:
                rc = code
                for other in alive:
                    procs[other].terminate()
        time.sleep(0.1)
    return rc


def main(argv=None) -> int:
    args = parse(argv)
    # one process with few threads: the host's share of a host-bound step
    # steadies when no thread pool spins beside it
    for var in THREADS:
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    from benchmark.harness import manifest

    try:
        cell = manifest.load_cell(args.workload)
    except (KeyError, OSError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not math.isfinite(args.seconds) or args.seconds <= 0:
        print("benchmark: --seconds must be positive", file=sys.stderr)
        return 2
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "benchmark", ".cache", sub)
    from benchmark.harness import device

    try:
        device.require_cards(cell.chips)
    except device.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    if cell.chips > 1 and "WORLD_SIZE" not in os.environ:
        return launch([sys.executable, os.path.abspath(__file__),
                       *(sys.argv[1:] if argv is None else argv)], cell.chips)
    import torch

    torch.set_num_threads(1)
    result = run(args, cell)
    return 0 if result is None else emit(result)


def emit(result: dict) -> int:
    """The run's end: refuse if a forbidden module is loaded, else each
    number compared beside its limit as the last lines of standard error
    and the result as the last line of standard output."""
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that the benchmark must not load: {bad}",
              file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
