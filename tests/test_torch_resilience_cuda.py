"""The resilient engine and the checkpoint container on the card.

- A CUDA generator's state (a seed and a Philox offset) survives save,
  restore and ``set_state``: the restored generator, and a fresh one given
  its state, draw what the saved one draws next.
- ``ea_simple`` OneMax at pop 4096 on the card in segments equals the
  uninterrupted run bit for bit, K1 launched once a generation; killed
  after generation 6 and resumed, the resumed run launches K1 once for
  each generation left and still equals it, and the caller's generator
  ends in the uninterrupted run's state.
- A double-buffered write whose next segment writes into the same
  tensors in place, on the same stream, right after the submit, still
  writes the boundary's values (the snapshot is an ordered copy); the
  restored tensors land on the card with their strides.

These tests need a CUDA card; they skip without one. On a machine with
one, from the repository's root (the file imports ``chip_smoke``):

    python -m pytest tests/test_torch_resilience_cuda.py -m cuda -q --noconftest

Tolerance: bitwise.
"""

import pytest
import torch

import chip_smoke
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels
from deap_tpu_torch.resilience import (FaultPlan, InjectedCrash, KillAt,
                                       ResilientRun)
from deap_tpu_torch.support import (AsyncCheckpointWriter, Checkpointer,
                                    restore_state, save_state)

pytestmark = pytest.mark.cuda

POP, NGEN, SEG = 4096, 12, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_generator_survives_save_restore_and_set_state(card, tmp_path):
    g = make_generator(5, card)
    torch.rand(1000, generator=g, device=card)
    path = str(tmp_path / "g.pkl")
    save_state(path, {"generator": g})
    out = restore_state(path, card)["generator"]
    assert out.device.type == "cuda"
    fresh = make_generator(0, card)
    fresh.set_state(out.get_state())
    want = torch.rand(64, generator=g, device=card)
    assert torch.equal(torch.rand(64, generator=out, device=card), want)
    assert torch.equal(torch.rand(64, generator=fresh, device=card), want)
    with pytest.raises(Exception, match="cuda generator"):
        restore_state(path, "cpu")


def _onemax(card, res):
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.support.stats import fitness_stats

    g = make_generator(3, card)
    pop = init_population(g, POP, ops.bernoulli_genome(chip_smoke.L),
                          FitnessSpec((1.0,)), device=card)
    tb = chip_smoke._onemax_toolbox(Toolbox, ops)
    kw = dict(stats=fitness_stats(), halloffame_size=1, device=card)
    if res is None:
        out = algorithms.ea_simple(g, pop, tb, chip_smoke.CXPB,
                                   chip_smoke.MUTPB, NGEN, **kw)
    else:
        out = res.ea_simple(g, pop, tb, chip_smoke.CXPB, chip_smoke.MUTPB,
                            NGEN, **kw)
    return out, g


def test_segmented_and_resumed_ea_simple_equal_uninterrupted(card, tmp_path):
    chip_smoke.reset_counts()
    want, g_want = _onemax(card, None)
    assert kernels.fused_variation.launches == NGEN
    for db in (False, True):
        chip_smoke.reset_counts()
        got, g = _onemax(card, ResilientRun(str(tmp_path / f"ck{db}"),
                                            segment_len=SEG,
                                            double_buffer=db))
        assert kernels.fused_variation.launches == NGEN
        assert chip_smoke.same_tree(torch, want, got)
        assert torch.equal(g.get_state(), g_want.get_state())
    d = str(tmp_path / "kill")
    with pytest.raises(InjectedCrash):
        _onemax(card, ResilientRun(d, segment_len=SEG,
                                   fault_plan=FaultPlan([KillAt(6)])))
    assert Checkpointer(d).steps() == [3]  # killed before gen 6's save
    chip_smoke.reset_counts()
    got, g = _onemax(card, ResilientRun(d, segment_len=SEG))
    assert kernels.fused_variation.launches == NGEN - 3
    assert chip_smoke.same_tree(torch, want, got)
    assert torch.equal(g.get_state(), g_want.get_state())


def test_double_buffered_snapshot_is_ordered_before_in_place_writes(
        card, tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    x = torch.arange(1 << 22, dtype=torch.float32, device=card)
    vt = torch.rand(512, 256, device=card).T  # column-major
    want_x, want_vt = x.clone(), vt.clone()
    writer = AsyncCheckpointWriter()
    writer.submit(ck, 1, {"x": x, "vt": vt})
    for _ in range(50):  # the next segment, on the same stream
        x.add_(1.0)
        vt.mul_(2.0)
    writer.wait()
    got = ck.restore(1, card)
    assert got["x"].device.type == "cuda"
    assert chip_smoke.same_tree(torch, {"x": want_x, "vt": want_vt}, got)
    assert got["vt"].stride() == vt.stride()
