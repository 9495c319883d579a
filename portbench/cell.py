"""One run of one cell: set-up, the measured window, the metrics, the check.

Everything specific to a configuration, a traffic mix or a metric is a file
that this module finds by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the deployment (data, index build, query
  parameters, k, the stated precision, and the metric: ``"euclidean"``
  or ``"cosine"``, which the check judges under; any other is refused;
  ``self_query.includes_self`` true where the self-query returns each
  row's own id, as the reference then does);
* ``traffic/<traffic>.json``: the calls (``pattern`` ``query``: batches of
  ``batch`` queries, each the next slice of a pool of ``pool`` noisy
  queries, with ``kwargs`` over the configuration's query keywords;
  ``pattern`` ``build``: a whole index build and its self-query a call);
  a key that the pattern does not read is refused;
* ``limits/<workload>.json``: the rows the check samples and each compared
  number's limit;
* ``metrics/<metric>.py``: a reader with ``read(ctx)`` (and optionally
  ``start(ctx)``, called as the window opens) that returns the metric's
  value, or None where it finds nothing to read. A metric
  ``<base>.<part>`` without a file of its own is read by ``<base>.py``.

Calls run back to back from one client (a closed loop), each ending in a
synchronise with its result on the device. The window runs until its
time is up and the call under way has finished; the rates divide the work
of every completed call by the window's whole length. Of each call's
answers only the rows that the check's sample takes are copied
(:class:`Reservoir`); the rest is freed with the call.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

import torch

from . import check, data, stats
from .reference import LOWER_PRECISION, check_metric, control_knn
from .trace import Tracer

__all__ = ["BENCH_DIR", "FORBIDDEN", "NoDevice", "Cell", "Reservoir", "load_manifest",
           "load_cell", "load_reader", "forbidden_modules", "run_cell"]

BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "annsearch_tpu"})
#: the keys a traffic file may hold, by pattern
TRAFFIC_KEYS = {"query": {"pattern", "batch", "pool", "kwargs"}, "build": {"pattern"}}
#: blocks of answer rows the check's sample holds
SLOTS = 64
#: calls of the cell's own shape made in set-up, by pattern
WARM_CALLS = {"query": 3, "build": 1}
#: device time the traced stretch aims at, and its most and fewest calls
TRACE_S, TRACE_MAX_CALLS, TRACE_MIN_CALLS = 1.5, 100, 3


class NoDevice(RuntimeError):
    """The run asks for more cards than the machine has."""


class Cell(SimpleNamespace):
    """A workload of the manifest with its files read: ``name``, ``chips``,
    ``cfg``, ``traffic``, ``limits``, ``end_to_end`` and ``per_layer`` (the
    manifest's metric entries that this cell reports)."""


def load_manifest(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _merge(base: dict, over: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _applies(entry: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in e2e_names if "moves" in entry else True


def load_cell(manifest: dict, name: str, bench_dir: Path = BENCH_DIR,
              overrides: dict | None = None) -> Cell:
    """The workload ``name`` with its configuration, traffic and limits
    (each merged with ``overrides[kind]`` where given)."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    over = overrides or {}

    def read(kind, stem):
        return _merge(json.loads((bench_dir / kind / f"{stem}.json").read_text()), over.get(kind))

    e2e = [m for m in manifest["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    traffic = read("traffic", w["traffic"])
    extra = set(traffic) - TRAFFIC_KEYS.get(traffic.get("pattern"), set())
    if extra:
        raise ValueError(f"traffic {w['traffic']!r} ({traffic.get('pattern')!r}) holds keys "
                         f"the harness does not read: {sorted(extra)}")
    cfg = read("configs", w["config"])
    try:
        check_metric(cfg.get("metric"))
    except ValueError as e:
        raise ValueError(f"configuration {w['config']!r}: {e}") from None
    return Cell(
        name=name, chips=int(w["chips"]), bench_dir=bench_dir,
        cfg=cfg, traffic=traffic,
        limits=read("limits", name), end_to_end=e2e,
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name, names)],
    )


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader ``metrics/<name>.py`` (names may hold dots), or for
    ``<base>.<part>`` without a file of its own, ``metrics/<base>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = bench_dir / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def _setup(cell: Cell, seed: int, device, log):
    """``(x, pool, call, state, work_per_call)``: the data, the query pool,
    a function that makes call ``i``, and the state the calls keep."""
    t = time.perf_counter()
    import annsearch_tpu_torch as at

    log(f"program imported in {time.perf_counter() - t:.3f} s")
    cfg, tr = cell.cfg, cell.traffic
    t = time.perf_counter()
    x = data.make_data(cfg["data"], seed, device)
    _sync(device)
    log(f"data {tuple(x.shape)} {cfg['data']['generator']} in {time.perf_counter() - t:.3f} s "
        "(the first draw on the card starts its context)")
    build = getattr(at, cfg["index"]["build"])
    bkw = dict(cfg["index"].get("kwargs", {}), device=device)
    k, state = int(cfg["k"]), {}
    if tr["pattern"] == "query":
        b, p = int(tr["batch"]), int(tr["pool"])
        if p % b:
            raise ValueError(f"pool {p} is no multiple of the batch {b}")
        pool, _ = data.noisy_subsample(x, p, float(cfg["queries"]["noise_std"]), seed)
        t = time.perf_counter()
        state["index"] = build(x, **bkw)
        _sync(device)
        log(f"index built ({cfg['index']['build']}) in {time.perf_counter() - t:.3f} s")
        query = getattr(at, cfg["query"]["fn"])
        qkw = dict(cfg["query"].get("kwargs", {}), **tr.get("kwargs", {}))

        def call(i):
            a = (i * b) % p
            return query(pool[a : a + b], state["index"], k, return_dist=True, **qkw)

        return x, pool, call, state, b
    if tr["pattern"] == "build":
        self_query = getattr(at, cfg["self_query"]["fn"])
        skw = cfg["self_query"].get("kwargs", {})

        def call(i):
            state["index"] = None       # the last build's memory is free for this one
            state["index"] = build(x, **bkw)
            return self_query(state["index"], k, return_dist=True, **skw)

        return x, None, call, state, int(x.shape[0])
    raise ValueError(f"unknown traffic pattern {tr['pattern']!r}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Reservoir:
    """The check's sample: ``SLOTS`` blocks of answer rows, drawn from the
    seed over every call that is offered.

    The ``width`` answer rows of a call are cut into blocks of
    ``sample // SLOTS`` by one permutation drawn from the seed; the blocks
    of the calls in turn form one stream, of which reservoir sampling
    (Li's algorithm L, its choices drawn from the seed) keeps ``SLOTS``.
    Only the rows a call gives to the reservoir are copied, into buffers
    made before the window, so the window holds no call's answers beyond
    its own."""

    def __init__(self, seed: int, width: int, sample: int):
        self.rows = max(1, min(width, sample // SLOTS))
        g = torch.Generator().manual_seed(data.seed_of(seed, 3))
        nb = width // self.rows
        self.blocks = torch.randperm(width, generator=g)[: nb * self.rows].view(nb, self.rows)
        self._rng = random.Random(data.seed_of(seed, 4))
        self.held: list[tuple[int, int] | None] = [None] * SLOTS
        self._seen = 0
        self._w = math.exp(math.log(self._rng.random()) / SLOTS)
        self._next = SLOTS - 1 + self._skip()
        self.ids = self.dists = self._blocks_dev = None

    def _skip(self) -> int:
        return int(math.log(self._rng.random()) / math.log(1.0 - self._w)) + 1

    def prepare(self, out) -> None:
        """Make the buffers after the shape and type of a call's answers."""
        ids, dists = out[0], out[1]
        self._blocks_dev = self.blocks.to(ids.device)
        self.ids = torch.empty((SLOTS, self.rows, ids.shape[1]), dtype=ids.dtype,
                               device=ids.device)
        self.dists = torch.empty((SLOTS, self.rows, dists.shape[1]), dtype=dists.dtype,
                                 device=dists.device)

    def offer(self, call: int, out) -> None:
        """Give the reservoir call ``call``'s answers ``(ids, dists)``."""
        nb = self.blocks.shape[0]
        lo, hi = self._seen, self._seen + nb
        take = {t: t - lo for t in range(lo, min(hi, SLOTS))}
        while self._next < hi:
            take[self._rng.randrange(SLOTS)] = self._next - lo
            self._w *= math.exp(math.log(self._rng.random()) / SLOTS)
            self._next += self._skip()
        self._seen = hi
        if not take:
            return
        for slot, blk in take.items():
            self.held[slot] = (call, blk)
        dev = self.ids.device
        slots = torch.tensor(list(take), device=dev)
        rows = self._blocks_dev[torch.tensor(list(take.values()), device=dev)]
        self.ids[slots] = out[0][rows]
        self.dists[slots] = out[1][rows]

    def answers(self):
        """``(calls, rows, ids, dists)``: for each answer row held, its call,
        its row in the call, and the ids and distances returned there."""
        full = [s for s, h in enumerate(self.held) if h is not None]
        calls = torch.tensor([self.held[s][0] for s in full]).repeat_interleave(self.rows)
        rows = torch.cat([self.blocks[self.held[s][1]] for s in full])
        k = self.ids.shape[-1]
        at = torch.tensor(full, device=self.ids.device)
        return calls, rows, self.ids[at].reshape(-1, k), self.dists[at].reshape(-1, k)


def _sample(cell: Cell, x, pool, res: Reservoir):
    """``(q, ids, dists, exclude)``: the answers the check compares."""
    calls, rows, ids, dists = res.answers()
    if cell.traffic["pattern"] == "query":
        b, p = int(cell.traffic["batch"]), int(cell.traffic["pool"])
        at = (calls * b) % p + rows
        return pool[at.to(pool.device)], ids, dists, None
    pick = rows.to(x.device)
    return x[pick], ids, dists, None if cell.cfg["self_query"].get("includes_self") else pick


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, control: bool = False, log=None) -> dict:
    """One run of ``cell``; returns the result line as a dict (``check``
    last). ``control=True`` adds ``numbers``, every number of the check,
    and ``control``, those of the reference at the next lower precision on
    the same sampled queries."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = torch.device(device).type == "cuda"
    t = time.perf_counter()
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        raise NoDevice(f"{cell.name} needs {cell.chips} CUDA card(s); "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    log(f"cell {cell.name}, seed {seed}, {seconds} s, trace {int(trace)}; {kind}; interpreter "
        f"and imports {t - t_start:.3f} s, the card found in {time.perf_counter() - t:.3f} s")

    x, pool, call, state, work = _setup(cell, seed, device, log)
    res = Reservoir(seed, work, int(cell.limits["sample"]))
    t = time.perf_counter()
    warm = []
    for i in range(WARM_CALLS[cell.traffic["pattern"]]):
        out = call(-1 - i)
        _sync(device)
        warm.append(time.perf_counter() - t)
        t = time.perf_counter()
    res.prepare(out)
    del out
    log("warm-up calls (s): " + ", ".join(f"{w:.4f}" for w in warm))
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load_reader(m["name"], cell.bench_dir) for m in metrics}
    ctx = SimpleNamespace(cell=cell, cfg=cell.cfg, traffic=cell.traffic, device=device,
                          kind=kind, seed=seed, x=x, pool=pool, state=state,
                          work_per_call=work, cache={}, timeline=None, traced_calls=[])
    for r in readers.values():
        if hasattr(r, "start"):
            r.start(ctx)

    n_trace = max(TRACE_MIN_CALLS, min(TRACE_MAX_CALLS, round(TRACE_S / max(warm[-1], 1e-6))))
    # the profiler starts at call 1; calls 2 .. 1 + n_trace are the stretch
    first_traced, tracer = 2, None
    failed, error = 0, None
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 0
    while True:
        if trace and i == first_traced - 1:
            tracer = Tracer(device)
            tracer.start()
        if tracer is not None and i == first_traced:
            tracer.open_window()
        try:
            out = call(i)
            _sync(device)
        except Exception as e:      # a failed call ends the window and the run's correctness
            failed, error, out = 1, f"{type(e).__name__}: {e}", None
        te = time.perf_counter()
        i += 1
        if tracer is not None and (i == first_traced + n_trace or failed):
            tracer.stop()
            ctx.timeline, ctx.traced_calls = tracer.timeline, list(range(first_traced, i))
            tracer = None
        if failed:
            break
        if not (trace and first_traced <= i - 1 < first_traced + n_trace):
            res.offer(i - 1, out)       # the traced stretch times the program alone
        out = None
        if te - t0 >= seconds and (not trace or i >= first_traced + n_trace):
            break
    window_s = te - t0
    completed = i - failed
    found = forbidden_modules()
    if found:
        raise ImportError(f"forbidden modules loaded: {', '.join(found)}")
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    power = _power_limit() if cuda else "no card"
    log(f"window {window_s:.4f} s, {completed} calls of {work} (failed {failed}); device "
        f"memory peak {setup_peak} B in set-up, {window_peak} B in the window; card: {power}")
    if error:
        log(f"call {i - 1} failed: {error}")

    ctx.setup_s, ctx.window_s, ctx.calls = setup_s, window_s, completed
    ctx.index = state.get("index")
    values = {}
    for name, r in readers.items():
        v = r.read(ctx) if completed else None
        if v is not None:
            values[name] = float(v)
    result = {
        "correct": False, "attempted": i, "failed": failed,
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in metrics if m["name"] in values},
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": max(setup_peak, window_peak)},
    }
    for name, v in values.items():
        if "roofline" in name:
            log(f"{name} {v} % of the published peak; card: {power}")
    if trace and ctx.timeline is not None:
        result["device"]["busy_s"] = ctx.timeline.busy_s
        result["device"]["window_s"] = ctx.timeline.window_s
        result["breakdown"] = ctx.timeline.breakdown()

    # the check: the program's state is freed first, then the reference runs
    if completed and not failed:
        q, ids, dists, exclude = _sample(cell, x, pool, res)
    state.clear()
    del res, out, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if failed or not completed:
        result["check"] = {"failed_calls": {"value": failed, "limit": 0}}
        return result
    t = time.perf_counter()
    metric = cell.cfg["metric"]
    numbers = check.compare(q, x, ids, dists, exclude, metric)
    ok, result["check"] = check.judge(numbers, cell.limits["limits"])
    result["correct"] = ok
    log(f"check on {q.shape[0]} sampled queries in {time.perf_counter() - t:.3f} s: " +
        ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
    if control:
        result["numbers"] = numbers
        prec = LOWER_PRECISION[cell.cfg["precision"]]
        c_ids, c_d = control_knn(q, x, ids.shape[1], prec, exclude, metric)
        result["control"] = dict(check.compare(q, x, c_ids, c_d, exclude, metric),
                                 precision=prec)
    result["check"] = result.pop("check")
    return result
