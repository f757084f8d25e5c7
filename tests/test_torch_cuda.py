"""The port's CUDA kernels on the card (skips without one).

Run on a machine with an NVIDIA card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The chunk kernels (csrc/queue_chunk.cu, every instance, and
csrc/awacs_chunk.cu) and the plain engine, the AWACS dwell kernel and
the plain boundary round (whose MLP is K5, the same row code), the bulk samplers
(csrc/bulk_samplers.cu) and their plain versions, and the bisect kernels
(csrc/bisect_stages.cu) and theirs, run the same IEEE operations on the
same inputs (the kernels are built with --fmad=false and take log1p, exp,
sqrt, cos and sin from CUDA's math library, as torch does on the card),
so every leaf, sample and event field must be equal.  K5 (csrc/nn_scores.cu) sums the MLP's
products in another order than the plain version's cuBLAS products, so
it is held to f32 roundoff, 1e-6, as the reference holds its own
kernel.
"""

import math

import pytest
import torch

from cimba_tpu_torch import config, interop, tree
from cimba_tpu_torch.core import kernel_run, loop
from cimba_tpu_torch.models import awacs, jobshop, mg1, mm1, mmc, tandem
from cimba_tpu_torch.random import bits, block_kernels
from cimba_tpu_torch.tools import bisect_kernels, cuda_bisect

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("t_end", [None, 40.0])
@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_kernel_matches_plain_engine(card, prof, t_end):
    """Whole run, and with a horizon (the kernel's own t_end check)."""
    with config.profile(prof):
        spec, _ = mm1.build(record=False)
        s0 = loop.init_sim(spec, 2026, torch.arange(512), mm1.params(80),
                           device=card)
        run = kernel_run.make_kernel_run(spec, t_end=t_end, chunk_steps=32)
        ker = run(s0)
        pla = loop.make_run(spec, t_end=t_end)(s0)
        torch.cuda.synchronize()
    assert run.launches > 0
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    if t_end is not None:  # the horizon cut the run short
        assert bool((ker.clock <= t_end).all())
        assert not bool(ker.done.all())


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["exponential_block", "normal_block",
                                  "exponential_block_zig"])
def test_block_kernels_match_plain(card, name, prof):
    """K2-K4 against their plain versions on the card, bit for bit, on
    streams of which every third one's counter crosses 2**32 in the
    block."""
    rows, n = 1000, 777
    with config.profile(prof):
        st = bits.initialize(2026, torch.arange(rows), device=card)
        wrap = torch.arange(rows, device=card) % 3 == 0
        st = st._replace(ctr_lo=torch.where(wrap, 0xFFFFFF00, st.ctr_lo))
        kernel = getattr(block_kernels, name)
        before = kernel.launches
        ks, kx = kernel(st, n)
        ps, px = getattr(block_kernels, f"{name}_plain")(st, n)
        torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(ks, ps))
    assert kx.dtype == px.dtype and kx.device.type == "cuda"
    assert torch.equal(kx, px)
    assert bool(torch.isfinite(kx).all())


@pytest.mark.parametrize("n", [1, 3, 4097])
@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["exponential_block", "normal_block"])
def test_block_kernels_edge_shapes(card, name, prof, n):
    """K2 and K3 at one stream and rows of 1, 3 and 4097 samples (a row
    of one short run, a long row with a short last run and no vector
    stores), the counter crossing 2**32 inside the row: each call one
    launch, bit for bit the plain version."""
    with config.profile(prof):
        st = bits.initialize(2026, torch.arange(1), device=card)
        for lo in (None, 2**32 - 1 - n // 2):
            s = st if lo is None else st._replace(
                ctr_lo=torch.full_like(st.ctr_lo, lo))
            kernel = getattr(block_kernels, name)
            before = kernel.launches
            ks, kx = kernel(s, n)
            ps, px = getattr(block_kernels, f"{name}_plain")(s, n)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            assert all(torch.equal(a, b) for a, b in zip(ks, ps))
            assert kx.shape == (1, n) and torch.equal(kx, px)


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_zig_kernel_takes_every_path(card, prof):
    """K4 over 1000 x 777 samples, where the plain version takes each of
    its paths (round 1's hot test, wedge and layer-0 tail, the same in
    round 2, the fallback): one launch, bit for bit."""
    with config.profile(prof):
        st = bits.initialize(2026, torch.arange(1000), device=card)
        before = block_kernels.exponential_block_zig.launches
        ks, kx = block_kernels.exponential_block_zig(st, 777)
        px, _, path = block_kernels._exp_zig_plain(st, 777)
        ps, _ = block_kernels.exponential_block_zig_plain(st, 777)
        torch.cuda.synchronize()
    counts = torch.bincount(path.flatten().long(),
                            minlength=len(block_kernels.ZIG_PATHS))
    assert int(counts.min()) > 0, counts.tolist()
    assert block_kernels.exponential_block_zig.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(ks, ps))
    assert torch.equal(kx, px)


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("rows,n", [(1, 1), (7, 1), (5, 9), (3, 13),
                                    (33, 31), (2, 4097)])
def test_zig_kernel_edge_shapes(card, prof, rows, n):
    """K4 at rows of one sample, odd n, runs that leave the grid's last
    warp part full, a counter crossing 2**32 in the row, and into an
    output view one element off 16 bytes (no vector stores): bit for bit
    the plain version."""
    real = torch.float32 if prof == "f32" else torch.float64
    with config.profile(prof):
        st = bits.initialize(2026, torch.arange(rows), device=card)
        st = st._replace(ctr_lo=torch.full_like(st.ctr_lo, 2**32 - 2 - n))
        ps, px = block_kernels.exponential_block_zig_plain(st, n)
        ks, kx = block_kernels.exponential_block_zig(st, n)
        base = torch.full((rows * n + 1,), float("nan"), dtype=real,
                          device=card)
        vs, vx = block_kernels._launch(
            "exponential_block_zig", st, n, 2 * block_kernels._ZK + 1,
            out=base[1:].view(rows, n))
        torch.cuda.synchronize()
    for got_s, got_x in ((ks, kx), (vs, vx)):
        assert all(torch.equal(a, b) for a, b in zip(got_s, ps))
        assert torch.equal(got_x, px)
    assert bool(torch.isnan(base[0]))


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("model,size,lanes", [
    ("mm1", 16, 301), ("mmc", 16, 301), ("mmc", 16, 37), ("jobshop", 16, 301),
    ("awacs", 1000, 301)])
def test_peek_kernel_planted_cases(card, model, size, lanes, prof):
    """K6's peek equal to peek_merged bit for bit on the planted cases
    (bisect_kernels.plant_peek_cases: ties in either table and across
    them, summed fields, empty lanes, -inf and NaN times), at the start
    and a few events in, at lane counts that leave the last warp part
    full; AWACS's 1001 wake rows a lane among them."""
    with config.profile(prof):
        st = cuda_bisect.Setup(model, card, lanes=lanes, size=size)
        s7 = st.plain(st.start, 7)
        for sims in (st.start, s7, bisect_kernels.plant_peek_cases(st.start),
                     bisect_kernels.plant_peek_cases(s7)):
            got = bisect_kernels.peek(sims, st.table, st.lay)
            want = bisect_kernels.peek_plain(sims)
            torch.cuda.synchronize()
            for a, b in zip(want, got):
                assert a.dtype == b.dtype
                assert torch.equal(cuda_bisect.bits(a), cuda_bisect.bits(b))


def test_nn_scores_kernel_matches_plain(card):
    rng = torch.Generator().manual_seed(7)
    for m in (137, 40_000):
        pos = (torch.rand((m, 2), generator=rng) * 160 - 80).to(card)
        vel = (torch.randn((m, 2), generator=rng) * awacs.SPEED).to(card)
        before = awacs.nn_forward.launches
        ker = awacs.nn_scores(pos, vel)
        pla = awacs.nn_scores_plain(pos, vel)
        torch.cuda.synchronize()
        assert awacs.nn_forward.launches == before + 1
        assert ker.dtype == torch.float32 and ker.device.type == "cuda"
        torch.testing.assert_close(ker, pla, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_awacs_kernel_matches_plain_engine(card, prof):
    """One chunk after the first dwell, then the whole host loop (chunks
    and dwell launches) against the plain engine run to the end (whose
    dwells run K5)."""
    with config.profile(prof):
        spec, _ = awacs.build(64)
        lay = kernel_run.awacs_layout(spec)
        s0 = loop.init_sim(spec, 2026, torch.arange(256), awacs.params(6.0),
                           device=card)
        plain = loop.make_run(spec, max_steps=64, defer_boundary=True)
        s1 = kernel_run.make_boundary_step(spec)(plain(s0))
        ker = kernel_run.awacs_chunk(tree.map(lambda x: x.clone(), s1), lay,
                                     64)
        pla = plain(s1)
        torch.cuda.synchronize()
        assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker),
                                   0.0) == []
        run = kernel_run.make_kernel_run(spec, chunk_steps=64)
        nn_before = awacs.nn_forward.launches
        dw_before = kernel_run.awacs_dwell.launches
        ker = run(s0)
        nn_launches = awacs.nn_forward.launches - nn_before
        dw_launches = kernel_run.awacs_dwell.launches - dw_before
        pla = loop.make_run(spec)(s0)
        torch.cuda.synchronize()
    # each boundary round is one dwell launch; the MLP runs inside it
    assert run.launches > 0 and run.boundary_rounds > 0
    assert dw_launches == run.boundary_rounds and nn_launches == 0
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    assert int(ker.err.abs().sum()) == 0


def _awacs_after_first_dwell(spec, card, lanes=256):
    """An AWACS Sim after its first dwell (every lane live)."""
    s0 = loop.init_sim(spec, 2026, torch.arange(lanes), awacs.params(6.0),
                       device=card)
    return kernel_run.make_boundary_step_plain(spec)(
        loop.make_run(spec, max_steps=64, defer_boundary=True)(s0))


@pytest.mark.parametrize("scoring", ["nn", "threshold"])
@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_awacs_dwell_matches_plain_round(card, prof, scoring):
    """The dwell kernel against the plain round (the plain engine's step
    on the gathered pending lanes, K5 in its MLP), bit for bit, on a Sim
    where only some lanes are pending: those get the step, the others
    keep every leaf."""
    import chip_smoke

    with config.profile(prof):
        spec, _ = awacs.build(64, scoring=scoring)
        lay = kernel_run.awacs_layout(spec)
        _, part = chip_smoke.partly_pending(
            spec, _awacs_after_first_dwell(spec, card), 256)
        pending = part.boundary_pending.clone()
        assert 0 < int(pending.sum()) < pending.numel()
        before = kernel_run.awacs_dwell.launches
        ker = kernel_run.awacs_dwell(tree.map(lambda x: x.clone(), part),
                                     lay)
        pla = kernel_run.make_boundary_step_plain(spec)(part)
        torch.cuda.synchronize()
    assert kernel_run.awacs_dwell.launches == before + 1
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    assert not bool(ker.boundary_pending.any())
    for x, y in zip(tree.leaves(part), tree.leaves(ker)):
        if x is not part.boundary_pending:
            assert torch.equal(x[~pending], y[~pending])


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_awacs_chunk_with_planted_ties(card, prof):
    """The chunk's two-level wake pick on ties: three targets at the
    least target wake time (different seqs), a fourth on every other
    lane, and a fifth at the sensor's wake time, where the sensor's prio
    wins; one chunk, and a chunk of three events, equal the plain
    chunk."""
    import chip_smoke

    with config.profile(prof):
        spec, _ = awacs.build(64)
        lay = kernel_run.awacs_layout(spec)
        s1 = chip_smoke.plant_ties(_awacs_after_first_dwell(spec, card), 64)
        for k in (3, 64):
            ker = kernel_run.awacs_chunk(tree.map(lambda x: x.clone(), s1),
                                         lay, k)
            pla = loop.make_run(spec, max_steps=k, defer_boundary=True)(s1)
            torch.cuda.synchronize()
            assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker),
                                       0.0) == []


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_awacs_heading_trig_matches_torch(card, dt):
    """The chunk's cos and sin (csrc/trig.cuh, no slow path) equal
    torch.cos and torch.sin on headings 2 pi u: every f32 u, and 2^24
    f64 ones spread over [0, 1) (chip_smoke.py takes all 2^32)."""
    import chip_smoke

    bits = 24 if dt == torch.float32 else 32
    k = torch.arange(1 << 24, dtype=torch.int64, device=card)
    if dt == torch.float64:
        k = k * 256 + (k * 97) % 256
    heading = 0.0 + 2.0 * math.pi * (k.to(dt) * 2.0**-bits)
    c, s = chip_smoke.heading_trig(heading)
    torch.cuda.synchronize()
    as_int = torch.int32 if dt == torch.float32 else torch.int64
    assert torch.equal(c.view(as_int), torch.cos(heading).view(as_int))
    assert torch.equal(s.view(as_int), torch.sin(heading).view(as_int))


def test_boundary_round_on_card_refuses_other_specs(card):
    """A CUDA Sim of a spec with boundary blocks but no dwell kernel."""
    from cimba_tpu_torch.core import process as cmd
    from cimba_tpu_torch.core.model import Model

    m = Model("jumpy")

    @m.boundary_block
    def dwell(sim, p, sig):
        return sim, cmd.hold(1.0, next_pc=dwell.pc)

    m.process("p", entry=dwell)
    spec = m.build()
    s0 = loop.init_sim(spec, 1, torch.arange(2), device=card)
    with pytest.raises(NotImplementedError, match="dwell"):
        kernel_run.make_boundary_step(spec)(s0)


def _queue_spec(name):
    if name == "mm1_record":
        return mm1.build()[0], mm1.params(40)
    if name == "mg1":  # every cell of the sweep among the 512 lanes
        p, _ = mg1.sweep_params(40, reps_per_cell=26)
        return mg1.build()[0], tuple(x[:512] for x in p)
    if name == "tandem":  # every cell of the grid among the 512 lanes
        p, _ = tandem.sweep_grid(40).rows(86)
        return tandem.build()[0], tuple(x[:512] for x in p)
    if name == "shop":  # backlog 4: the maintenance process runs
        return jobshop.build(backlog=4.0)[0], jobshop.params(40)
    c = int(name[-1])
    return mmc.build(c)[0], mmc.params(40, 0.83 * c, 1.0)


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["mm1_record", "mmc1", "mmc2", "mmc3",
                                  "mmc4", "mg1", "tandem", "shop"])
def test_queue_instances_match_plain_engine(card, name, prof):
    """Every recording instance of the single-queue kernel: one chunk,
    then the whole run, the queues' length accumulators (the job shop's
    pool's and buffer's) included."""
    with config.profile(prof):
        spec, params = _queue_spec(name)
        lay = kernel_run.queue_layout(spec)
        s0 = loop.init_sim(spec, 2026, torch.arange(512), params,
                           device=card)
        ker = kernel_run.queue_chunk(tree.map(lambda x: x.clone(), s0), lay,
                                     16)
        pla = loop.make_run(spec, max_steps=16)(s0)
        torch.cuda.synchronize()
        assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker),
                                   0.0) == []
        run = kernel_run.make_kernel_run(spec, chunk_steps=32)
        ker = run(s0)
        pla = loop.make_run(spec)(s0)
        torch.cuda.synchronize()
    assert run.launches > 0 and bool(ker.done.all())
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    if name == "shop":
        assert bool(ker.pools.acc.started.all())
        assert bool(ker.buffers.acc.started.all())
        assert bool((ker.user["maintenance_runs"] >= 1).any())
    else:
        assert bool(ker.queues.acc.started.all())


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("model", ["mm1", "mm1-record", "mmc", "jobshop",
                                   "awacs"])
def test_bisect_kernels_match_plain(card, model, prof):
    """K6: the copy byte for byte, the peek equal to peek_merged, at the
    start and a few events in; an odd lane count puts the end of every
    bool leaf off a 16-byte boundary (the copy's byte path)."""
    for lanes in (300, 301):
        with config.profile(prof):
            st = cuda_bisect.Setup(model, card, lanes=lanes, size=16)
            for sims in (st.start, st.plain(st.start, 7)):
                n_copy, n_peek = (bisect_kernels.sim_copy.launches,
                                  bisect_kernels.peek.launches)
                cp = bisect_kernels.sim_copy(sims, st.table, st.lay)
                got = bisect_kernels.peek(sims, st.table, st.lay)
                want = bisect_kernels.peek_plain(sims)
                torch.cuda.synchronize()
                assert bisect_kernels.sim_copy.launches == n_copy + 1
                assert bisect_kernels.peek.launches == n_peek + 1
                for a, b in zip(tree.leaves(sims), tree.leaves(cp)):
                    assert torch.equal(cuda_bisect.bits(a),
                                       cuda_bisect.bits(b))
                for a, b in zip(want, got):
                    assert a.dtype == b.dtype
                    assert torch.equal(cuda_bisect.bits(a),
                                       cuda_bisect.bits(b))


def _plant(sims):
    """Events in the general event table, which mm1 and mmc never use: an
    early K_PROC wake of the arrival, an arrival timer that its exit
    cancels, ties at t=0 with the process starts (by prio and by seq), an
    out-of-range subject, a server's wake.  The chunk kernel caches the
    table's minimum; these make it pop from the table and rescan."""
    ev = sims.events
    lanes = torch.arange(ev.time.shape[0], device=ev.time.device)
    cols = {f: getattr(ev, f).clone()
            for f in ("time", "prio", "seq", "kind", "subj", "arg")}
    rows = ((0, 1, 0.5, 0, 50, 0, 0), (0, 2, 1e6, 0, 51, 1, 0),
            (0, 3, 0.0, 0, 1, 0, 7), (1, 0, 0.0, 1, 60, 0, 1),
            (2, 0, 2.0, 0, 61, 1, 0), (3, 0, 3.0, 0, 62, 0, 1))
    for slot, phase, t, prio, seq, kind, subj in rows:
        if slot >= ev.time.shape[1]:
            continue
        m = lanes % (4 if slot == 0 else slot + 1) == phase
        for f, v in zip(("time", "prio", "seq", "kind", "subj", "arg"),
                        (t, prio, seq, kind, subj, 0)):
            cols[f][m, slot] = v
    return sims._replace(events=ev._replace(**cols))


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["mm1", "mm1_record", "mmc1", "mmc2",
                                  "mmc3", "mmc4", "mg1", "tandem", "shop"])
def test_queue_kernel_general_table(card, name, prof):
    """Every single-queue engine instance with events planted in the
    general table: one chunk, and the whole run, equal to the plain
    engine."""
    with config.profile(prof):
        if name == "mm1":
            spec, params = mm1.build(record=False)[0], mm1.params(40)
        else:
            spec, params = _queue_spec(name)
        lay = kernel_run.queue_layout(spec)
        s0 = _plant(loop.init_sim(spec, 2026, torch.arange(512), params,
                                  device=card))
        ker = kernel_run.queue_chunk(tree.map(lambda x: x.clone(), s0), lay,
                                     16)
        pla = loop.make_run(spec, max_steps=16)(s0)
        torch.cuda.synchronize()
        assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker),
                                   0.0) == []
        ker = kernel_run.make_kernel_run(spec, chunk_steps=32)(s0)
        pla = loop.make_run(spec)(s0)
        torch.cuda.synchronize()
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []


def test_awacs_kernels_have_no_stack_frame(card):
    """ptxas' report of csrc/awacs_chunk.cu: the chunk and dwell
    instances keep no stack frame and spill nothing, in either profile
    (chip_smoke.py checks the same)."""
    import chip_smoke
    from cimba_tpu_torch import _build

    _, report = _build.build("awacs_chunk")
    figs, faults = chip_smoke.awacs_frames(
        chip_smoke.build_report("awacs_chunk", report))
    assert faults == [] and len(figs) == 4


def test_queue_chunk_has_no_stack_frame(card):
    """ptxas' report of csrc/queue_chunk.cu: the mm (1, false), (1,
    true) and (3, true), the mg1, the tandem and the job-shop instances
    keep no stack frame and spill nothing, in either profile
    (chip_smoke.py checks the same)."""
    import chip_smoke
    from cimba_tpu_torch import _build

    _, report = _build.build("queue_chunk")
    figs, faults = chip_smoke.queue_frames(
        chip_smoke.build_report("queue_chunk", report))
    assert faults == []
    assert len(figs) >= 16  # every instance in both profiles


# --- the generated K1 (user specs) ------------------------------------------

def _user_spec(name):
    """A user spec that runs on a generated instance: (spec, params,
    horizon, seed)."""
    from cimba_tpu_torch.examples import (cookbook_balking, tut_3_balking,
                                          tut_4_harbor)
    from cimba_tpu_torch.tools import usergen

    if name == "park3":  # to its end (every lane ends well before t=400)
        return tut_3_balking.build(), None, tut_3_balking.T_END, 11
    if name == "park2":  # to its end: the end event stops every animal
        from cimba_tpu_torch.examples import tut_2_park
        return tut_2_park.build()[0], None, None, tut_2_park.SEED
    if name == "hello":
        from cimba_tpu_torch.examples import tut_0_hello
        return tut_0_hello.build(), None, None, 1
    if name.startswith("usergenr"):
        seed = int(name[len("usergenr"):])
        return (usergen.build(seed, usergen.torch_lib(), resources=True)[0],
                None, 20.0, 11)
    if name == "abort":
        return usergen.abort_spec(usergen.torch_lib()), None, 15.0, 11
    if name == "spawnshop":  # to its end: api.stop once 200 are served
        from cimba_tpu_torch.examples import spawn_shop
        return spawn_shop.build(), None, None, spawn_shop.SEED
    if name == "spawnmm1":  # to its end: api.stop once 30 are done
        return usergen.spawn_mm1_spec(usergen.torch_lib()), None, None, 11
    if name == "waitev":  # the reference's wait_event model, to its end
        return usergen.wait_event_spec(usergen.torch_lib()), None, None, 17
    if name in ("masswake", "joins"):  # wait_process, to the end
        return (usergen.wait_process_spec(usergen.torch_lib(),
                                          joins=name == "joins"),
                None, None, 1)
    if name.startswith("usergenw"):  # to its end
        seed = int(name[len("usergenw"):])
        return (usergen.build(seed, usergen.torch_lib(), waits=True)[0],
                None, None, 11)
    if name.startswith("usergens"):  # to its end
        seed = int(name[len("usergens"):])
        return (usergen.build(seed, usergen.torch_lib(), spawn=True)[0],
                None, None, 11)
    if name.startswith("usergent"):
        seed = int(name[len("usergent"):])
        return (usergen.build(seed, usergen.torch_lib(), timers=True)[0],
                None, 15.0, 11)
    if name == "balking":
        return cookbook_balking.build()[0], cookbook_balking.params(60), \
            None, 7
    if name == "harbor":
        return tut_4_harbor.build(), tut_4_harbor.params(), 60.0, 4
    if name == "mm1":  # forced onto the generated route
        return mm1.build()[0], mm1.params(60), None, 2026
    seed = int(name[len("usergen"):])
    return usergen.build(seed, usergen.torch_lib())[0], None, None, 11


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["balking", "harbor", "mm1", "usergen1",
                                  "usergen2"])
def test_generated_instances_match_plain_engine(card, name, prof):
    """A generated instance, driven by its host loop (the user programs
    through make_kernel_run, which chooses the generated family for
    them), equals the plain engine on the card leaf for leaf, floats bit
    for bit; mm1.build()'s generated instance equals its hand-written
    one on a chunk."""
    with config.profile(prof):
        spec, params, t_end, seed = _user_spec(name)
        s0 = loop.init_sim(spec, seed, torch.arange(512), params,
                           device=card)
        lay, wrapper, table = kernel_run.generated_kernel_for(spec, s0)
        if name == "mm1":
            hlay, hk, _ = kernel_run.kernel_for(spec)
            a = hk(tree.map(lambda x: x.clone(), s0), hlay, 64)
            b = wrapper(tree.map(lambda x: x.clone(), s0), lay, 64)
            torch.cuda.synchronize()
            assert interop.diff_leaves(tree.leaves(a), tree.leaves(b),
                                       0.0) == []
            return
        before = kernel_run.gen_chunk.launches
        ker = kernel_run.make_kernel_run(spec, t_end=t_end,
                                         chunk_steps=64)(s0)
        pla = loop.make_run(spec, t_end=t_end)(s0)
        torch.cuda.synchronize()
    assert kernel_run.gen_chunk.launches > before
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    assert int(ker.err.ne(0).sum()) == 0


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["park3", "abort", "usergent5", "usergent6",
                                  "usergent7"])
def test_generated_timers_and_interrupts_match_plain_engine(card, name,
                                                            prof):
    """The generated instances with the priority queues, timers,
    timers_clear, interrupts and the abort's cleanup (tutorial 3's park;
    a spec whose pool waiter times out and whose buffer waiter is
    interrupted, reaching the rollback and the partial report; three
    usergen specs with the later verbs): driven by their host loop to a
    horizon, equal to the plain engine on the card leaf for leaf, floats
    bit for bit, with the waits really aborted."""
    with config.profile(prof):
        spec, params, t_end, seed = _user_spec(name)
        s0 = loop.init_sim(spec, seed, torch.arange(512), params,
                           device=card)
        before = kernel_run.gen_chunk.launches
        ker = kernel_run.make_kernel_run(spec, t_end=t_end,
                                         chunk_steps=64)(s0)
        pla = loop.make_run(spec, t_end=t_end)(s0)
        torch.cuda.synchronize()
    assert kernel_run.gen_chunk.launches > before
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    assert int(ker.err.ne(0).sum()) == 0
    if name == "abort":
        assert int(ker.user["timeouts"].sum()) > 0
        assert float(ker.user["partial"].sum()) > 0.0
    if name == "park3":
        li = ker.procs.locals_i[:, :8]
        assert int(li[:, :, 3].sum()) > 0  # reneges
        assert torch.equal(li[:, :, 1].sum(dim=1), ker.user["served"])


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["park2", "hello", "usergenr1", "usergenr2",
                                  "usergenr3"])
def test_generated_preempt_resources_handlers_match_plain_engine(card, name,
                                                                 prof):
    """The generated instances with the pool preempt's mug, binary
    resources (acquire, preempt, release), user event handlers and
    stop_process (tutorial 2's park to its end; hello; three usergen
    specs of resources=True to a horizon): driven by their host loop,
    equal to the plain engine on the card leaf for leaf, floats bit for
    bit; the park's gates hold."""
    with config.profile(prof):
        spec, params, t_end, seed = _user_spec(name)
        s0 = loop.init_sim(spec, seed, torch.arange(512), params,
                           device=card)
        before = kernel_run.gen_chunk.launches
        ker = kernel_run.make_kernel_run(spec, t_end=t_end,
                                         chunk_steps=64)(s0)
        pla = loop.make_run(spec, t_end=t_end)(s0)
        torch.cuda.synchronize()
    assert kernel_run.gen_chunk.launches > before
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    assert int(ker.err.ne(0).sum()) == 0
    if name == "park2":
        from cimba_tpu_torch.examples import tut_2_park
        assert tut_2_park.check_gates(ker) > 0
    if name.startswith("usergenr"):
        assert int(ker.user["kicked"].sum()) > 0


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["spawnshop", "usergens1", "usergens2",
                                  "usergens4", "usergens13", "usergens14",
                                  "spawnmm1"])
def test_generated_spawn_pools_match_plain_engine(card, name, prof):
    """The generated instances with spawn pools: past 10 processes their
    wakes and words in shared columns and their columns in dynamic shared
    memory (the spawn shop, 17 processes; usergen specs of spawn=True, 12
    to 32 processes, seeds 1, 4 and 14 with 9 guards), and the reference's
    per-customer M/M/1 (9 processes, its wakes and words in registers, the
    spawned row reached through their compile-time pids): driven by their
    host loop to the end, equal to the plain engine on the card leaf for
    leaf, floats bit for bit; the shop's gates hold; the 32-process
    instance takes more than 48 KB of shared memory a block."""
    with config.profile(prof):
        spec, params, t_end, seed = _user_spec(name)
        s0 = loop.init_sim(spec, seed, torch.arange(512), params,
                           device=card)
        lay = kernel_run.generated_kernel_for(spec, s0)[0]
        before = kernel_run.gen_chunk.launches
        ker = kernel_run.make_kernel_run(spec, t_end=t_end,
                                         chunk_steps=64)(s0)
        pla = loop.make_run(spec, t_end=t_end)(s0)
        torch.cuda.synchronize()
    big = spec.n_procs > 10
    assert big == (name != "spawnmm1")
    assert f"BIG = {str(big).lower()}," in lay["header"]
    assert kernel_run.gen_chunk.launches > before
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    assert int(ker.err.ne(0).sum()) == 0
    smem = kernel_run.gen_smem_bytes(lay["header"])
    assert (smem > 0) == big
    if name == "spawnshop":
        from cimba_tpu_torch.examples import spawn_shop
        spawn_shop.check_gates(ker)
    if name == "usergens13":
        assert spec.n_procs == 32 and smem > 48 * 1024
    if name.startswith("usergens"):
        assert bool((ker.user["missed"] > 0).all())
    if name == "spawnmm1":
        from cimba_tpu_torch.tools import usergen

        assert bool((ker.user["done"] == usergen.SPAWN_MM1_CUSTOMERS).all())
        assert bool(ker.user["order_ok"].all())


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["waitev", "masswake", "joins",
                                  "usergenw21", "usergenw3", "usergenw5",
                                  "usergenw1", "usergenw4"])
def test_generated_waits_match_plain_engine(card, name, prof):
    """The generated instances of the waits and the event-handle API: the
    reference's wait_event model (the cell waitev's), wait_process's
    mass wake and joins, and usergen specs of waits=True (10 processes,
    the waits in registers; 12 to 15, in shared columns; the draining,
    eager, lazy arms, a reschedule): driven by their host loop to the
    end, equal to the plain engine on the card leaf for leaf, floats bit
    for bit; every lane ends with every process finished; the header
    carries the waits the spec returns."""
    with config.profile(prof):
        spec, params, t_end, seed = _user_spec(name)
        s0 = loop.init_sim(spec, seed, torch.arange(512), params,
                           device=card)
        lay = kernel_run.generated_kernel_for(spec, s0)[0]
        before = kernel_run.gen_chunk.launches
        ker = kernel_run.make_kernel_run(spec, t_end=t_end,
                                         chunk_steps=64)(s0)
        pla = loop.make_run(spec, t_end=t_end)(s0)
        torch.cuda.synchronize()
    assert kernel_run.gen_chunk.launches > before
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    assert int(ker.err.ne(0).sum()) == 0
    assert bool((ker.procs.status == 2).all())
    h = lay["header"]
    assert ("WAITP = true" in h) == (name != "waitev")
    assert ("WAITE = true" in h) == (name == "waitev"
                                     or name.startswith("usergenw"))
    if name == "waitev":
        fires = ker.user["fires"].to(ker.n_events.dtype)
        assert bool((ker.n_events == 3 * fires).all())


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_generated_trig_past_the_fast_path(card, prof):
    """sin and cos of a generated block equal torch's on the card for
    arguments past the library's fast path too (|x| >= 105615 in f32,
    2^31 in f64, up to the dtype's range: chip_smoke.TRIG_SCALES), with
    no failed lane; so does every device sampler."""
    import chip_smoke

    with config.profile(prof):
        spec = chip_smoke.sampler_spec()
        s0 = loop.init_sim(spec, 2026, torch.arange(512), None, device=card)
        lay, wrapper, _ = kernel_run.generated_kernel_for(spec, s0)
        ker = wrapper(tree.map(lambda x: x.clone(), s0), lay, 16)
        pla = loop.make_run(spec, max_steps=16)(s0)
        torch.cuda.synchronize()
    assert interop.diff_leaves(tree.leaves(pla), tree.leaves(ker), 0.0) == []
    assert int(ker.err.ne(0).sum()) == 0
    assert all(bool(torch.isfinite(pla.user[f"{f}{j}"]).all())
               for f in ("sin", "cos") for j in range(5))


def test_generated_instances_have_no_stack_frame(card):
    """ptxas' report of the generated harbor, balking, park3, abort and
    a timed usergen instance, and the waits' instances (waitev,
    wait_process's two forms, usergen specs of waits=True): the chunk
    kernel keeps no stack frame and spills nothing in either profile (the
    harbor's sin is queue_chunk.cu's frame-free trig_of)."""
    import chip_smoke
    from cimba_tpu_torch import _build

    for name in ("balking", "harbor", "park3", "park2", "abort",
                 "usergent5", "usergenr1", "spawnshop", "usergens13",
                 "usergens14", "spawnmm1", "waitev", "masswake", "joins",
                 "usergenw21", "usergenw3", "usergenw5"):
        for prof in ("f32", "f64"):
            spec, s = chip_smoke.gen_template(name, prof)
            with config.profile(prof):
                lay = kernel_run.generated_kernel_for(spec, s)[0]
            path, _, report = _build.build_gen(lay["header"])
            report = report or path.with_suffix(".log").read_text()
            f = chip_smoke.print_gen_ptxas(f"{name} {prof}", report)
            assert f["frame"] == 0 and f["spill_stores"] == 0


def test_generated_route_refuses_unported_sampler_on_card(card):
    """A user spec whose block draws a sampler without a device
    counterpart raises on the card, naming it; nothing runs the plain
    engine instead."""
    import cimba_tpu_torch.random as cr
    from cimba_tpu_torch.core import api
    from cimba_tpu_torch.core import process as cmd
    from cimba_tpu_torch.core.model import Model

    m = Model("weibullish")

    @m.block
    def wait(sim, p, sig):
        sim, t = api.draw(sim, cr.weibull, 2.0, 1.0)
        return sim, cmd.hold(t, next_pc=wait.pc)

    m.process("p", entry=wait)
    spec = m.build()
    s0 = loop.init_sim(spec, 1, torch.arange(4), device=card)
    with pytest.raises(NotImplementedError, match="weibull"):
        kernel_run.make_kernel_run(spec, t_end=5.0)(s0)
