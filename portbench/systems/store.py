"""Driver of the bitmap-index store: ``BitmapStore`` over SSB LINEORDER.

A configuration of this system (``"system": "store"``) gives the table
(``scale_factor``, ``rows_per_sf``, the ``columns`` kept and the
bit-sliced ones, ``bsi``). A traffic mix gives the queries, each a
conjunction of conditions ``["eq", col, v]`` / ``["range", col, lo, hi]``
(closed bounds, ``null`` open), taken in turn by one client, and what a
request asks (``request``):

* ``count``: ``BitmapStore.count(pred, fused=True)``;
* ``revenue``: ``sum(sum * weight)`` as the store can answer it, one
  ``sum_`` for each value ``d`` of the query's range on ``weight``:
  ``Σ_d d · sum_(sum, and_(pred without weight, eq(weight, d)))``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import loop
from portbench.bench import (RunRecord, Window, device_info, load_kernels,
                             use_program)
from portbench.yardstick import control as ctl
from portbench.yardstick import gen, judge, reference, roaring_bytes

__all__ = ["run", "PortStore", "ControlStore", "split_weight"]


def split_weight(conds, weight: str):
    """(the conditions without ``weight``'s, the values of ``weight`` the
    query names)."""
    rest = [c for c in conds if c[1] != weight]
    mine = [c for c in conds if c[1] == weight]
    if len(mine) != 1:
        raise ValueError(f"a revenue query names {weight!r} once")
    _, lo, hi = reference.cond_values(mine[0])
    if lo is None or hi is None:
        raise ValueError(f"a revenue query bounds {weight!r} on both sides")
    return rest, list(range(lo, hi + 1))


class PortStore:
    """The program: one ``BitmapStore`` answering through its public
    ``count`` and ``sum_``."""

    def __init__(self, run, records):
        cfg, tr = run.config, run.traffic
        self.run, self.tr = run, tr
        with run.phase("program"):
            use_program(run.root)
            from repro_torch import store as ST
        self.ST = ST
        with run.phase("kernels"):
            load_kernels(run)
        with run.phase("build"):
            self.store = ST.BitmapStore.build(records, bsi=cfg["bsi"],
                                              device=run.device)

    def _pred(self, conds):
        ST = self.ST
        atoms = [ST.eq(c[1], c[2]) if c[0] == "eq"
                 else ST.range_(c[1], c[2], c[3]) for c in conds]
        return ST.and_(*atoms)

    def prepare(self, query):
        conds, tr = query["where"], self.tr
        if tr["request"] == "revenue":
            rest, ds = split_weight(conds, tr["weight"])
            return [(d, self._pred(rest + [["eq", tr["weight"], d]]))
                    for d in ds]
        return self._pred(conds)

    def request(self, q):
        tr, st, call = self.tr, self.store, self.run.call
        if tr["request"] == "count":
            return call("store.count", lambda: st.count(q, fused=True))
        return sum(d * call("store.sum_", st.sum_, tr["sum"], p)
                   for d, p in q)

    def counters(self) -> dict:
        from repro_torch.kernels.roaring import kernel as K
        stats = self.store.cache_stats()
        return {"store.plan_hits": stats["hits"],
                "store.plan_misses": stats["misses"],
                **{f"launches.{k}": v for k, v in K.launch_counts.items()}}

    def close(self):
        del self.store


class ControlStore:
    """The control in the program's place (``yardstick.control``): counts
    estimated chunk by chunk as if the conditions were independent, sums
    accumulated in int32."""

    def __init__(self, run, records):
        self.records, self.tr = records, run.traffic
        self.memo = {}

    def prepare(self, query):
        return query["name"], query["where"]

    def request(self, q):
        name, conds = q
        if name not in self.memo:
            tr = self.tr
            if tr["request"] == "count":
                self.memo[name] = ctl.estimate_ssb_count(self.records, conds)
            else:
                self.memo[name] = ctl.int32_ssb_sum(
                    self.records, conds, tr["sum"], tr["weight"])
        return self.memo[name]

    def counters(self) -> dict:
        return {}

    def close(self):
        pass


def want_answer(records, conds, tr) -> int:
    if tr["request"] == "count":
        return reference.ssb_answer(records, conds)
    return reference.ssb_answer(records, conds, sum_col=tr["sum"],
                                weight_col=tr["weight"])


def bitmaps_read(records, cfg, conds, tr):
    """Keys of the bitmaps a plain evaluation of one request reads: an
    equality column's posting of each value the query names, every slice
    of a bit-sliced column it names, every slice of the summed column."""
    keys = []
    cols = [c[1] for c in conds] + (
        [tr["sum"]] if tr["request"] != "count" else [])
    for cond in conds:
        col, lo, hi = reference.cond_values(cond)
        if col in cfg["bsi"]:
            continue
        keys += [("eq", col, int(v)) for v in np.unique(records[col])
                 if (lo is None or v >= lo) and (hi is None or v <= hi)]
    for col in dict.fromkeys(cols):
        if col in cfg["bsi"]:
            bits = max(1, int(records[col].max()).bit_length())
            keys += [("slice", col, j) for j in range(bits)]
    return list(dict.fromkeys(keys))


def run(run) -> RunRecord:
    cfg, tr, seed = run.config, run.traffic, run.seed
    if tr["request"] not in ("count", "revenue"):
        raise ValueError(f"a store request is count or revenue, "
                         f"not {tr['request']!r}")
    with run.phase("generate"):
        table = gen.ssb_lineorder(run.torch, cfg["scale_factor"], seed,
                                  cfg.get("rows_per_sf", 6_000_000),
                                  device=run.device)
        records = {c: table[c] for c in cfg["columns"]}
        del table
    run.fresh_peak()
    server = (run.server or PortStore)(run, records)
    queries = tr["queries"]
    with run.phase("traffic"):
        pool = [server.prepare(q) for q in queries]
    with run.phase("warmup"):
        loop.serial_loop(server, pool, float("inf"),
                         n_max=tr.get("warmup_rounds", 2) * len(pool))
    window = Window(run, server)
    window.open()
    out = loop.serial_loop(server, pool, run.seconds, window=window)
    device = device_info(run)
    server.close()
    if run.device == "cuda":
        run.torch.cuda.empty_cache()

    t = time.perf_counter()
    per_query = [want_answer(records, q["where"], tr) for q in queries]
    want = {i: per_query[i % len(queries)] for i in range(out.submitted)}
    run.log(f"reference: {len(queries)} queries in "
            f"{time.perf_counter() - t:.1f} s")
    memo, per = {}, {}

    def nbytes(key):
        if key not in memo:
            kind, col, v = key
            m = (records[col] == v if kind == "eq"
                 else (records[col] >> v) & 1 == 1)
            memo[key] = roaring_bytes.mask_bytes(m)
        return memo[key]

    def request_bytes(i):
        q = i % len(queries)
        if q not in per:
            per[q] = 8 + sum(nbytes(k) for k in bitmaps_read(
                records, cfg, queries[q]["where"], tr))
        return per[q]

    return window.record("store", out, device,
                         judge.compare(out.answers, want), request_bytes,
                         counted_requests=out.submitted)
