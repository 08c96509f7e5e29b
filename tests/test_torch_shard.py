"""The port's ``shard_clients`` on the ``fused`` engine against its own
unsharded rounds and the reference's unsharded rounds, on the CPU, over 2
gloo processes and a world of 1 (``tests/_torch_shard_checks.py`` states
the cases and the tolerances; ``tests/test_torch_shard_e2e.py`` holds
``fused_e2e`` and the block).  Also ``run_federated(shard_clients=True,
fleet_store="host")`` on ``fused_e2e``, cohort 3 on 2 ranks: its record
against the unsharded run, its pad-aware prefetch hints, and its
checkpoints, written by rank 0 alone."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_shard_checks as chk  # noqa: E402
import _torch_shard_worker as w  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return chk.shard_runs(tmp_path_factory.mktemp("shard"), "fused")


@pytest.mark.parametrize("case", chk.cases("fused"), ids=chk.case_ids("fused"))
def test_sharded_integers_are_the_unsharded_rounds(runs, case):
    chk.check_integers(runs, case)


@pytest.mark.parametrize("case", chk.cases("fused"), ids=chk.case_ids("fused"))
def test_sharded_floats_are_the_port_unsharded_rounds(runs, case):
    chk.check_port_floats(runs, case)


@pytest.mark.parametrize("case", chk.cases("fused"), ids=chk.case_ids("fused"))
def test_sharded_floats_are_the_reference_unsharded_rounds(runs, case):
    chk.check_ref_floats(runs, case)


def test_both_ranks_hold_the_same_state(runs):
    chk.check_ranks_equal(runs)


def test_at_world_size_one_sharded_is_unsharded_bit_for_bit(runs):
    chk.check_world_one(runs)


def test_the_sharded_federation_is_the_unsharded_one(runs):
    want = runs["fed"]
    one_sample = 1.0 / w.FED["eval_size"] + 1e-9
    for got in (r["fed"] for r in runs["ranks"][:2]):
        assert got["per_client_k"] == want["per_client_k"] and got["bytes"] == want["bytes"]
        np.testing.assert_allclose(got["server_acc"], want["server_acc"], rtol=0, atol=one_sample)
        np.testing.assert_allclose(got["client_acc"], want["client_acc"], rtol=0, atol=one_sample)
        np.testing.assert_allclose(got["distill_loss"], want["distill_loss"], rtol=1e-4)


def test_each_rank_stages_the_rows_it_fetches(runs):
    """The pad-aware hint: a rank stages its block of the NEXT round's
    padded cohort, which is what it fetches then.  Rank 1, which writes no
    checkpoint, finds the last round's rows staged (rank 0's checkpoint
    write drops what is staged, as a host store's save does unsharded; and
    a fetch can take a hint a round early when a rank's block repeats: the
    store keys staged rows by the rows)."""
    rounds = len(runs["fed"]["per_client_k"])
    blocks = []
    for got in (r["fed"] for r in runs["ranks"][:2]):
        fetched = [sel for sel, _hit in got["hits"]]
        assert len(fetched) == rounds and all(len(sel) == 2 for sel in fetched)
        assert got["hints"] == fetched[1:]
        blocks.append(fetched)
    assert runs["ranks"][1]["fed"]["hits"][-1][1]
    for first, second in zip(*blocks):  # the two blocks are the padded cohort of 3
        assert len(set(first + second)) == 3 and second[-1] == first[0]


def test_rank_zero_alone_writes_the_checkpoints(runs):
    r0, r1 = (r["fed"] for r in runs["ranks"][:2])
    steps = [f"step_{s:08d}.npz" for s in (1, 2, 3)]
    assert r1["writes"] == []
    assert [f for f in r0["writes"] if f.startswith("step_")] == steps
    assert sorted(f for f in os.listdir(runs["ckpt"]) if f.endswith(".npz")) == steps
