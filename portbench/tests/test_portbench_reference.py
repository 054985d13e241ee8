"""The plain reference against a row loop, and the seeded generator."""

import torch

from portbench.yardstick import gen, reference


def test_ssb_reference_matches_a_row_loop():
    rec = gen.ssb_lineorder(torch, 0.002, 9)
    conds = [["eq", "lo_year", 1993], ["range", "lo_discount", 1, 3],
             ["range", "lo_quantity", None, 24]]
    rows = [i for i in range(rec["lo_year"].size)
            if rec["lo_year"][i] == 1993 and 1 <= rec["lo_discount"][i] <= 3
            and rec["lo_quantity"][i] <= 24]
    assert reference.ssb_answer(rec, conds) == len(rows)
    assert reference.ssb_answer(rec, conds, sum_col="lo_extendedprice") == \
        sum(int(rec["lo_extendedprice"][i]) for i in rows)
    assert reference.ssb_answer(rec, conds, sum_col="lo_extendedprice",
                                weight_col="lo_discount") == \
        sum(int(rec["lo_extendedprice"][i]) * int(rec["lo_discount"][i])
            for i in rows)


def test_generator_is_seeded_and_well_formed():
    rec = gen.ssb_lineorder(torch, 0.001, 4)
    again = gen.ssb_lineorder(torch, 0.001, 4)
    other = gen.ssb_lineorder(torch, 0.001, 2 ** 31 + 11)
    assert all((rec[c] == again[c]).all() for c in rec)
    assert any((rec[c] != other[c]).any() for c in rec)
    assert {c.size for c in rec.values()} == {6000}
    assert rec["lo_discount"].min() >= 0 and rec["lo_discount"].max() <= 10
    assert rec["lo_quantity"].min() >= 1 and rec["lo_quantity"].max() <= 50
    assert 1992 <= rec["lo_year"].min() <= rec["lo_year"].max() <= 1998
