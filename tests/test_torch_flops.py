"""The FLOP count of one iteration (`ipddp2tpu_torch/scripts/flops_analysis.py`).

- Its rules on a hand-built function, to the exact count.
- The pieces whose work per stage is fixed (derivatives, costate scan,
  contraction, one backward sweep, one rollout of the search, one trial's
  measures): between concar at T = 32 and at T = 16 each grows by 16 times
  its count for one stage (T = 17 less T = 16), which is not zero. A count
  that took a loop's body once, as XLA's HLO cost analysis does, fails
  this.
- Four identical lanes cost four times one lane, within 1 %.
- The JAX script's lines for B = 1 in both settings, and no aten operation
  of concar's iteration without a rule.
"""

import re

import torch

from ipddp2tpu_torch.scripts import flops_analysis as fa

torch.set_num_threads(1)


def test_rules_on_a_hand_built_function():
    """bmm [3, 5, 7] x [3, 7, 2]: 2 * 3 * 5 * 7 * 2 = 420; the add and the
    exp on its 30 outputs: 30 each (the exp also a transcendental); the sum
    of 30 to one: 29. Views and comparisons: zero."""
    gen = torch.Generator().manual_seed(0)
    a = torch.rand((3, 5, 7), generator=gen, dtype=torch.float64)
    b = torch.rand((3, 7, 2), generator=gen, dtype=torch.float64)
    counter = fa.FlopCounter()
    with counter:
        c = torch.bmm(a, b) + 1.0
        s = c.exp().sum()
        (s > 0) & (c.reshape(-1)[3] < 2)
    assert sum(counter.flops.values()) == 420 + 30 + 30 + 29
    assert sum(counter.transcendentals.values()) == 30
    assert counter.by_rule == {"products": 420, "arithmetic": 30,
                               "transcendental": 30, "reduction": 29,
                               "zero": 0}
    assert not counter.uncounted


def test_fixed_work_pieces_grow_with_the_horizon():
    counts = {T: fa.count(1, torch.float64, "cpu", T=T)
              for T in (16, 17, 32)}
    for piece in fa.PIECES.values():
        first = {T: c["by_piece"][piece]["calls"][0]
                 for T, c in counts.items()}
        stage = first[17] - first[16]
        assert stage > 0, piece
        assert first[32] - first[16] == 16 * stage, (piece, first)


def test_identical_lanes_scale_with_the_batch():
    four = fa.count(4, torch.float64, "cpu", T=16, identical=True)
    one = fa.count(1, torch.float64, "cpu", T=16)
    assert four["trials"] == one["trials"]
    assert abs(four["flops"] - 4 * one["flops"]) <= 0.01 * 4 * one["flops"]
    assert abs(four["transcendentals"] - 4 * one["transcendentals"]) \
        <= 0.01 * 4 * one["transcendentals"]


def test_main_prints_the_jax_scripts_lines(capsys):
    """concar at T = 100, B = 1, f32 with backtracking and f64 with the
    speculative search: the JAX script's line for each, and no uncounted
    operation."""
    assert fa.main(["1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = re.compile(r"^b=1 (f32|f64) \(ls_spec=(0|8)\): (\S+) "
                      r"flops/batch-iter = (\S+) per instance-iter$")
    found = [m.groups() for m in map(line.match, out.splitlines()) if m]
    assert [g[:2] for g in found] == [("f32", "0"), ("f64", "8")], out
    for g in found:
        assert float(g[2]) == float(g[3]) > 1e6
    assert "uncounted" not in out, out
