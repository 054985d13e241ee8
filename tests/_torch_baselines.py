"""Port parity checks: the paper's RLE baselines and the analytic FLOP
model.

The tier-1 run reaches them through existing items, because each CPU item
the suite adds moves xdist's first chunks and crashes a worker of
``test_dispatch.py`` (ROADMAP queue 3d): ``check_baselines`` runs in
``test_torch_roaring.py::test_slab_and_codec_equal_reference`` and
``check_flops`` in ``test_torch_train.py::test_train_steps_match_reference``.
Each also stands alone as a named test when this file is named on the
command line (``python -m pytest tests/_torch_baselines.py -k flops``).
Against the reference package, on the CPU, with inputs made from a seed
with numpy; everything compares exactly:

* the baselines: WAH, Concise and BitSet of the port against the
  reference's, word for word — the ``encode_groups`` / ``decode_groups``
  streams, the built objects' words, ``to_array``, ``cardinality``,
  ``and_`` / ``or_`` under the ``expanded`` engine and, for WAH, the
  ``streaming`` engine with its words-touched counter, ``append`` /
  ``remove``, and ``size_in_bytes`` (BitSet's allocated and trimmed) — over
  uniform, clustered, run-heavy, empty and single-value sets and values on
  the 31-bit group edges;
* ``models/flops.py``: ``cell_flops`` (every term), ``model_flops_reference``
  and ``cell_hbm_bytes`` for every config of the reference registry (the
  port's two archs and the others carried over field for field), full and
  reduced, each kind, at two sequence lengths.
"""

import dataclasses

import numpy as np

from _torch_parity import release_jax_executables  # noqa: F401
from repro import baselines as JB
from repro.baselines import _groups as JG
from repro.baselines import concise as JC
from repro.baselines import wah as JW
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_config
from repro.models import flops as JF
from repro_torch import baselines as TB
from repro_torch.baselines import _groups as TG
from repro_torch.baselines import concise as TC
from repro_torch.baselines import wah as TW
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_config as t_config
from repro_torch.models import flops as TF
from repro_torch.models.config import ModelConfig as TModelConfig

SEED = 1402


def _sets():
    """Named value sets: uniform, clustered, run-heavy, empty, single
    values, and values on the 31-bit group edges."""
    rng = np.random.default_rng(SEED)
    edges = np.array(sorted({31 * g + d for g in (0, 1, 2, 5, 6, 1000, 1001)
                             for d in (-1, 0, 30) if 31 * g + d >= 0}))
    clustered = np.unique(np.concatenate([
        rng.integers(c, c + 3000, 1800) for c in (0, 40_000, 200_000)]))
    runs = np.unique(np.concatenate([
        np.arange(s, s + n) for s, n in ((0, 31 * 40), (31 * 700 + 3, 5000),
                                         (150_000, 62), (250_001, 2))]))
    return {
        "uniform": np.unique(rng.integers(0, 1 << 18, 3000)),
        "sparse": np.unique(rng.integers(0, 1 << 20, 400)),
        "clustered": clustered,
        "runs": runs,
        "alternate": np.arange(0, 62 * 300, 62),       # Concise's mixed fill
        "edges": edges,
        "empty": np.zeros((0,), np.int64),
        "single": np.array([31 * 77 + 30]),
        "zero": np.array([0]),
    }


def _same_words(a, b, what):
    assert a.dtype == b.dtype and np.array_equal(a, b), what


def check_baselines():
    sets = _sets()
    for name, v in sets.items():
        _check_streams(name, v)
    names = list(sets)
    pairs = list(zip(names, names[1:] + names[:1])) + [
        ("uniform", "uniform"), ("runs", "clustered"), ("empty", "empty")]
    for codec in ("wah", "concise", "bitset"):
        for a, b in pairs:
            _check_pair(codec, sets[a], sets[b], f"{codec} {a} x {b}")
        for name, v in sets.items():
            _check_updates(codec, v, f"{codec} {name}")


def _check_streams(name, v):
    jg, tg = JG.indices_to_groups(v), TG.indices_to_groups(v)
    _same_words(jg, tg, f"groups {name}")
    _same_words(JG.groups_to_indices(jg), TG.groups_to_indices(tg),
                f"indices {name}")
    for jm, tm in ((JW, TW), (JC, TC)):
        jw, tw = jm.encode_groups(jg), tm.encode_groups(tg)
        _same_words(jw, tw, f"{tm.__name__} encode {name}")
        _same_words(jm.decode_groups(jw), tm.decode_groups(tw),
                    f"{tm.__name__} decode {name}")


def _build(codec, v):
    cls = {"wah": "WahBitmap", "concise": "ConciseBitmap",
           "bitset": "BitSet"}[codec]
    return (getattr(JB, cls).from_sorted_unique(v),
            getattr(TB, cls).from_sorted_unique(v))


def _same_bitmap(j, t, what):
    _same_words(j.words, t.words, what)
    _same_words(j.to_array(), t.to_array(), what)
    assert j.cardinality == t.cardinality, what
    assert j.size_in_bytes() == t.size_in_bytes(), what
    if hasattr(j, "trimmed_size_in_bytes"):
        assert j.trimmed_size_in_bytes() == t.trimmed_size_in_bytes(), what
        assert j.words_in_use == t.words_in_use, what
    else:
        assert j._max == t._max, what


def _check_pair(codec, a, b, what):
    (ja, ta), (jb, tb) = _build(codec, a), _build(codec, b)
    _same_bitmap(ja, ta, what)
    for op, want in (("and_", np.intersect1d(a, b)),
                     ("or_", np.union1d(a, b))):
        j, t = getattr(ja, op)(jb), getattr(ta, op)(tb)
        _same_bitmap(j, t, f"{what} {op}")
        assert np.array_equal(t.to_array(), want), f"{what} {op}"
    if codec == "wah":
        for op in ("and_streaming", "or_streaming"):
            (j, jn), (t, tn) = getattr(ja, op)(jb), getattr(ta, op)(tb)
            _same_words(j.words, t.words, f"{what} {op}")
            assert jn == tn, f"{what} {op} words touched"


def _check_updates(codec, v, what):
    j, t = _build(codec, v)
    x = int(v[-1]) if v.size else -1
    for step in range(12):
        x += 1 + (step * 37) % 70
        j.append(x)
        t.append(x)
        _same_bitmap(j, t, f"{what} append {x}")
    x += 31 * 40_000 + 7                             # a long zero fill
    j.append(x)
    t.append(x)
    _same_bitmap(j, t, f"{what} append {x}")
    for x in list(j.to_array()[::25]) + [int(j.to_array()[-1]), 3]:
        j.remove(int(x))
        t.remove(int(x))
        _same_bitmap(j, t, f"{what} remove {x}")


def check_flops():
    assert set(T_ARCHS) <= set(J_ARCHS)
    for arch in J_ARCHS:
        for reduced in (False, True):
            jc = j_config(arch, reduced=reduced)
            tc = (t_config(arch, reduced=reduced) if arch in T_ARCHS else
                  TModelConfig(**dataclasses.asdict(jc)))
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), arch
            for kind in ("train", "prefill", "decode"):
                for seq in (4096, 32768):
                    kw = dict(kind=kind, seq_len=seq, global_batch=8)
                    j, t = JF.cell_flops(jc, **kw), TF.cell_flops(tc, **kw)
                    what = (arch, reduced, kind, seq)
                    assert (t.matmul, t.attention, t.elementwise, t.total) \
                        == (j.matmul, j.attention, j.elementwise,
                            j.total), what
                    assert TF.model_flops_reference(tc, **kw) == \
                        JF.model_flops_reference(jc, **kw), what
                    assert TF.cell_hbm_bytes(tc, **kw) == \
                        JF.cell_hbm_bytes(jc, **kw), what
            assert TF.cell_hbm_bytes(tc, kind="train", seq_len=4096,
                                     global_batch=1, optimizer="adafactor") \
                == JF.cell_hbm_bytes(jc, kind="train", seq_len=4096,
                                     global_batch=1, optimizer="adafactor")


# named tests, collected only when this file is named on the command line


def test_baselines_match_reference():
    check_baselines()


def test_flops_match_reference():
    check_flops()
