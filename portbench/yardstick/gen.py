"""Seeded inputs of the benchmark: SSB LINEORDER rows.

A frozen copy, so that a change to the program cannot move the yardstick.
``ssb_lineorder`` draws what ``chip_smoke.ssb_lineorder`` draws, from the
same law, but in a few large calls on the card (so that set-up stays
short), and so not the same stream of numbers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ssb_lineorder"]


SSB_FIRST_DAY = np.datetime64("1992-01-01")
SSB_DAYS = int((np.datetime64("1998-08-02") - SSB_FIRST_DAY).astype(
    np.int64)) + 1


def _ssb_calendar():
    """d_year, d_yearmonthnum and d_weeknuminyear of each SSB day."""
    day = SSB_FIRST_DAY + np.arange(SSB_DAYS)
    year = day.astype("datetime64[Y]").astype(np.int64) + 1970
    month = day.astype("datetime64[M]").astype(np.int64) % 12 + 1
    week = (day - day.astype("datetime64[Y]")).astype(np.int64) // 7 + 1
    return year, year * 100 + month, week


def ssb_lineorder(torch, sf: float, seed: int, rows_per_sf: int = 6_000_000,
                  device="cpu"):
    """SSB LINEORDER at scale factor ``sf`` (SF x 6,000,000 rows) from the
    spec's column domains: orders of 1-7 lines (TPC-H) in order-key order,
    each with one order date uniform over 1992-01-01 .. 1998-08-02 shared
    by its lines; lo_discount 0-10 and lo_quantity 1-50 uniform per line;
    lo_extendedprice = lo_quantity x P_RETAILPRICE (cents) of a uniform
    part key among SF's 200,000 x (1 + log2 SF) parts. The date columns are
    the DATE dimension's d_year, d_yearmonthnum, d_weeknuminyear. Drawn on
    ``device`` from a generator seeded with ``seed``; host int64 columns."""
    n_rows = int(round(sf * rows_per_sf))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))

    def draw(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=device,
                             dtype=torch.int64)

    lines = draw(1, 8, n_rows // 4 + 65536)
    while int(lines.sum()) < n_rows:
        lines = torch.cat([lines, draw(1, 8, 65536)])
    n_orders = int(torch.searchsorted(torch.cumsum(lines, 0),
                                      torch.tensor(n_rows, device=device))) + 1
    lines = lines[:n_orders]
    day = torch.repeat_interleave(draw(0, SSB_DAYS, n_orders), lines)[:n_rows]
    n_parts = 200_000 * int(1 + np.log2(max(sf, 1)))
    partkey = draw(1, n_parts + 1, n_rows)
    quantity = draw(1, 51, n_rows)
    retail = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)
    cols = {"lo_discount": draw(0, 11, n_rows), "lo_quantity": quantity,
            "lo_extendedprice": quantity * retail}
    for name, tab in zip(("lo_year", "lo_yearmonthnum", "lo_weeknuminyear"),
                         _ssb_calendar()):
        cols[name] = torch.as_tensor(tab, device=device)[day]
    return {k: v.cpu().numpy() for k, v in cols.items()}
