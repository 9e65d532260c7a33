"""The PyTorch port's tick tables against the JAX package's, bit for bit:
``compile_schedule(...).table``, ``makespan``, ``n_act_slots`` and
``n_grad_slots`` (pure numpy on both sides), and the schedule
configuration rules."""

import numpy as np
import pytest

from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    schedules as jsched)
from distributed_training_with_pipeline_parallelism_tpu.utils import (
    config as jconfig)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    schedules as tsched)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    config as tconfig)

GRID = [(1, 1, 1), (1, 1, 3), (2, 1, 1), (2, 1, 4), (3, 1, 2), (3, 1, 5),
        (4, 1, 4), (4, 1, 8), (2, 2, 4), (4, 2, 8), (2, 3, 6), (4, 2, 3)]


@pytest.mark.parametrize("name", ["GPipe", "1F1B", "Interleaved1F1B", "BFS"])
@pytest.mark.parametrize("D,V,M", GRID)
def test_tick_tables_bit_identical(name, D, V, M):
    """Equal tables (int32, every cell), makespans, slot counts and
    bubble fractions; where the JAX package refuses a (D, V, M) (1F1B with
    M < D, one stage per device for GPipe/1F1B, Interleaved's round rule)
    the port refuses it with the same error type."""
    try:
        want = jsched.compile_schedule(name, D, V, M)
    except jsched.ScheduleError as e:
        with pytest.raises(tsched.ScheduleError):
            tsched.compile_schedule(name, D, V, M)
        assert isinstance(e, ValueError)
        return
    got = tsched.compile_schedule(name, D, V, M)
    assert got.table.dtype == want.table.dtype == np.int32
    np.testing.assert_array_equal(got.table, want.table)
    assert (got.makespan, got.n_act_slots, got.n_grad_slots) == (
        want.makespan, want.n_act_slots, want.n_grad_slots)
    assert tsched.analytic_bubble_fraction(name, D, V, M) == \
        jsched.analytic_bubble_fraction(name, D, V, M)


@pytest.mark.parametrize("name,L,D", [
    ("Interleaved1F1B", 12, 4), ("Interleaved1F1B", 12, 2),
    ("Interleaved1F1B", 8, 4), ("1F1B", 12, 2), ("GPipe", 12, 2),
    ("BFS", 12, 2)])
def test_virtual_stages_rule_matches_jax(name, L, D):
    """The reference rule: V = 2 for Interleaved1F1B iff L % (2D) == 0,
    so GPT-2-small's 12 layers get V = 1 at D = 4 and V = 2 at D = 2."""
    assert tconfig.virtual_stages_for(name, L, D) == \
        jconfig.virtual_stages_for(name, L, D)


def test_verify_table_catches_a_stale_slot():
    cs = tsched.compile_schedule("1F1B", 2, 1, 4)
    bad = cs.table.copy()
    t, d = np.argwhere(bad[:, :, tsched.COL_BWD_M] >= 0)[-1]
    bad[t, d, tsched.COL_BWD_ASLOT] = cs.n_act_slots  # a slot never written
    with pytest.raises(tsched.ScheduleError, match="saved-input slot"):
        tsched.verify_table(tsched.CompiledSchedule(
            cs.name, 2, 1, 4, bad, cs.makespan, cs.ticks, cs.n_act_slots,
            cs.n_grad_slots))
