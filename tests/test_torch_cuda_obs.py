"""The observability plane on the card (skips without one): the
determinism audit over K1's chunks, the kernel-path contract, and the
recorder and registry on the plain engine on the card.

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest tests/test_torch_cuda_obs.py -m cuda -q

* ``sim_digest`` of a state on the card equals its digest on the CPU,
  in both profiles, and the class sums wrap mod 2**64 there as here;
* an audited stream through K1 (mm1, 512 replications of 30 objects in
  waves of 256, K=32) has the trail of the same stream driven by the
  plain engine on the card, row for row and class for class, and its
  results are bitwise the unaudited stream's;
* ``usergen.fail_spec`` on its generated instance fails every lane and
  equals the plain engine;
* a Sim carrying the ring or the registry, and the runners with either
  on, are refused on the card;
* tutorial 1's traced pass on the card gives the CPU's ring (integers
  equal, times within 1e-9) and registry.
"""

import warnings

import pytest
import torch

from cimba_tpu_torch import config, interop, tree
from cimba_tpu_torch.core import kernel_run, loop
from cimba_tpu_torch.examples import tut_1_mm1
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.obs import metrics as om
from cimba_tpu_torch.obs import trace as ot
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.tools import usergen
from cimba_tpu_torch.utils import logger

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    yield torch.device("cuda")
    ot.disable()
    om.disable()


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_digest_on_the_card_equals_the_cpu(card, prof):
    with config.profile(prof):
        spec, _ = mm1.build(record=False)
        s = loop.make_run(spec, max_steps=9)(loop.init_sim(
            spec, 3, torch.arange(64), mm1.params(20), device="cpu"))
        on_card = tree.map(lambda x: x.to(card), s)
        assert audit.format_digests(audit.sim_digest(on_card)) == \
            audit.format_digests(audit.sim_digest(s))
    vals = [2**63 - 1, 2**63 - 5, 2**64 - 3, 2**64 - 1]
    h = torch.tensor([audit._i64(v) for v in vals], device=card)
    assert int(audit._sum_u64(h)) & audit._U64 == sum(vals) % 2**64


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_k1_trail_equals_plain_engine_trail(card, prof):
    with config.profile(prof):
        spec, _ = mm1.build(record=False)
        kw = dict(wave_size=256, chunk_steps=32, seed=7)
        a = audit.Audit()
        got = ex.run_experiment_stream(spec, mm1.params(30), 512, audit=a,
                                       **kw)
        plain = ex.run_experiment_stream(spec, mm1.params(30), 512, **kw)
        assert audit.stream_result_digest(plain) == \
            got.audit["result_digest"]
        # the same waves through the plain engine on the card
        want = audit.Audit()
        cond = loop.make_cond(spec)
        step = loop.make_run(spec, max_steps=32)

        def chunk(s):
            s = step(s)
            return s, cond(s).any(), audit.sim_digest(s)

        for w in range(2):
            s = loop.init_sim(spec, ex._seed_column(7, 256, card),
                              torch.arange(256 * w, 256 * (w + 1)),
                              mm1.params(30), device=card)
            loop.drive_chunks(chunk, s, poll_every=4,
                              on_digest=lambda n, v, w=w:
                              want.on_chunk(w, n, v))
    assert a.trail_rows() == want.trail_rows()


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_fail_spec_on_k1(card, prof):
    with config.profile(prof):
        spec = usergen.fail_spec(usergen.torch_lib())
        s0 = loop.init_sim(spec, 5, torch.arange(1024), device=card)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = kernel_run.make_kernel_run(spec, chunk_steps=16)
            ker = run(s0)
        assert any("failure flag is preserved" in str(w.message)
                   for w in caught)
        logger.flags_off(logger.ERROR | logger.FATAL)
        try:
            pla = loop.make_run(spec)(s0)
        finally:
            logger.flags_on(logger.ERROR | logger.FATAL)
    assert run.launches > 0
    assert bool((ker.err == loop.ERR_USER).all())
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []


def test_refusals_on_the_card(card):
    spec, _ = mm1.build(record=False)
    for mod, what in ((ot, "flight-recorder"), (om, "metrics registry")):
        mod.enable()
        try:
            s = loop.init_sim(spec, 1, torch.arange(8), mm1.params(5),
                              device=card)
            with pytest.raises(RuntimeError, match=what):
                kernel_run.kernel_for(spec, s)
            for fn in (ex.run_experiment, ex.run_experiment_chunked,
                       ex.run_experiment_stream):
                with pytest.raises(RuntimeError, match="on the card"):
                    fn(spec, mm1.params(5), 8)
        finally:
            mod.disable()


def test_traced_pass_on_the_card_equals_the_cpu(card, tmp_path):
    cpu, _, _ = tut_1_mm1.traced_run(device="cpu",
                                     out_path=str(tmp_path / "c.json"))
    gpu, _, doc = tut_1_mm1.traced_run(device=card,
                                       out_path=str(tmp_path / "g.json"))
    for f in ("pid", "kind", "arg", "seq", "count"):
        assert torch.equal(getattr(gpu.trace, f).cpu(), getattr(cpu.trace, f))
    torch.testing.assert_close(gpu.trace.t.cpu(), cpu.trace.t, rtol=1e-9,
                               atol=0)
    for a, b in zip(gpu.metrics, cpu.metrics):
        assert torch.equal(a.cpu(), b)
    assert doc["otherData"]["recorded_events"] > 0
