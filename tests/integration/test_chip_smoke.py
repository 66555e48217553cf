"""chip_smoke.py: its phases at a tiny size on the CPU, its refusal to run
without a GPU, and the float64 oracle it judges answers with.

The same phases at full size run on the card with ``python chip_smoke.py``;
``test_phases_on_gpu`` runs them small there under ``-m gpu``.
"""
import numpy as np
import pytest

import chip_smoke as cs


def _reporter():
    return cs.Reporter("cpu", cs.Clock())


def test_session_phase_matches_oracle_on_cpu():
    rep = _reporter()
    cs.phase_session(rep, 2000, 32, seed=0, chunk_rows=500, n_single=4,
                     batch=16)
    assert rep.failures == []


def test_scale_phase_every_regime_matches_oracle_on_cpu():
    rep = _reporter()
    cs.phase_scale(rep, 3000, 32, seed=0, n_single=4, batch=16,
                   ivf_clusters=16, ivf_probe=4)
    assert rep.failures == []


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_program_key_names_batch_and_static_args():
    x, q = np.zeros((8, 4), np.float32), np.zeros((3, 4), np.float32)
    assert cs.program_key("k", (x, q, 5), {}) == "k[B=3,5]"
    assert cs.program_key("k", (x, q), {"ov_k": 16, "k": 2}) \
        == "k[B=3,k=2,ov_k=16]"


def test_compare_flags_wrong_answers(rng):
    x = rng.standard_normal((500, 8)).astype(np.float32)
    live = np.ones(500, bool)
    live[7] = False
    q = x[[3, 9]] + 0.01
    d, rows = cs.exact_topk(x, live, q, 5)
    good = cs.compare(x, live, q, rows, d, k=5)
    assert good["recall_ties_excused"] == 1.0
    assert good["max_rel_dist_err"] < 1e-6
    bad_rows = rows.copy()
    bad_rows[0, 0] = 7  # a deleted row in place of the nearest
    bad = cs.compare(x, live, q, bad_rows, d * 1.01, k=5)
    assert bad["recall"] < 1.0 and bad["deleted_returned"] == 1
    assert bad["max_rel_dist_err"] > 1e-3


@pytest.mark.gpu
def test_phases_on_gpu(gpu):
    rep = cs.Reporter(gpu.device_kind, cs.Clock())
    cs.phase_session(rep, 20_000, 128, seed=0, chunk_rows=5_000)
    cs.phase_scale(rep, 50_000, 128, seed=0, ivf_clusters=64)
    assert rep.failures == []
