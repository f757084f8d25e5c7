"""``tools.usergen.abort_spec``, a model whose waits are aborted from
outside every few events (a pool waiter's timeout rolls back its partial
grab, a buffer waiter's interrupt keeps its partial take and reports
it): the port's plain engine against cimba_tpu on the CPU in both
profiles (6 lanes, seed 11, to t=30), leaf for leaf as in
``test_torch_usergen_timers.py``; the rollbacks and the reports really
happen."""

import torch

from test_torch_usergen_timers import check_plain_engine_matches_reference

torch.set_num_threads(1)


def test_abort_spec_matches_reference():
    out = check_plain_engine_matches_reference("abort")
    assert int(out.user["timeouts"].sum()) > 0
    assert float(out.user["partial"].sum()) > 0.0
    # every unit of the pool is held or in the pool (a rollback returns
    # the waiter's grab)
    total = out.pools.level[:, 0] + out.pools.held[:, 0].sum(dim=1)
    assert bool((total == 4.0).all())


def test_abort_spec_matches_reference_f32():
    check_plain_engine_matches_reference("abort", "f32")
