"""The port's ``shard_clients`` on the ``fused_e2e`` engine, one round at a
time and as the ``run_rounds`` block, against its own unsharded rounds and
the reference's unsharded rounds, on the CPU, over 2 gloo processes and a
world of 1 (``tests/_torch_shard_checks.py`` states the cases and the
tolerances).  The block runs the cohorts ``[[0, 1, 2], [1, 2, 3]]`` with
its eval tap, as the reference's two-device test drives it, and is held to
the unsharded block as that test holds it: taps within 1e-6 (accuracies)
and rtol 1e-4 (distill loss)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_shard_checks as chk  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return chk.shard_runs(tmp_path_factory.mktemp("shard_e2e"), "fused_e2e")


@pytest.mark.parametrize("case", chk.cases("fused_e2e"), ids=chk.case_ids("fused_e2e"))
def test_sharded_integers_are_the_unsharded_rounds(runs, case):
    chk.check_integers(runs, case)


@pytest.mark.parametrize("case", chk.cases("fused_e2e"), ids=chk.case_ids("fused_e2e"))
def test_sharded_floats_are_the_port_unsharded_rounds(runs, case):
    chk.check_port_floats(runs, case)


@pytest.mark.parametrize("case", chk.cases("fused_e2e"), ids=chk.case_ids("fused_e2e"))
def test_sharded_floats_are_the_reference_unsharded_rounds(runs, case):
    chk.check_ref_floats(runs, case)


def test_both_ranks_hold_the_same_state(runs):
    chk.check_ranks_equal(runs)


def test_at_world_size_one_sharded_is_unsharded_bit_for_bit(runs):
    chk.check_world_one(runs)


def test_the_sharded_block_is_the_unsharded_block(runs):
    got, want = runs["ranks"][0]["block"], runs["block"]
    assert got["ks"] == want["ks"] and got["bytes"] == want["bytes"]
    assert [len(ks) for ks in got["ks"]] == [3, 3]  # the pad row is no client
    np.testing.assert_allclose(got["server_acc"], want["server_acc"], atol=1e-6)
    np.testing.assert_allclose(got["client_acc"], want["client_acc"], atol=1e-6)
    np.testing.assert_allclose(got["distill_loss"], want["distill_loss"], rtol=1e-4)
    for part in ("lora", "s_lora"):
        for k, v in want["state"][part].items():
            assert chk.rel(got["state"][part][k], v) <= chk.TO_PORT, (part, k)
