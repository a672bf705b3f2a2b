"""`chip_smoke.check_first_tokens`, the card's first-token comparison:
equal tokens pass without a prefill; a difference passes only where the
two tokens are the two largest logits of the prompt prefilled alone and
their gap, taken in f32 from the final features, is at most one bf16
step at the larger one's magnitude. A stub executor's model has an
identity head, so its designed features are the logits."""
import os
import sys
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


class _Model:
    """The head of a model whose final features are its logits: an
    identity `lm_head` over 8 tokens, no pad columns."""

    def __init__(self):
        self.cfg = SimpleNamespace(tie_embeddings=False, vocab_size=8,
                                   padded_vocab=8)
        self.params = {"lm_head": torch.eye(8, dtype=torch.bfloat16)}

    def unembed(self, x):
        return x @ self.params["lm_head"]


class _Stub:
    """prefill(prompt, n) unembeds the features `rows[prompt[0]]` (1, V),
    as the executor's prefill does through its model."""

    def __init__(self, rows):
        self.rows, self.calls, self.model = rows, [], _Model()

    def prefill(self, prompt, pad_to):
        self.calls.append(prompt[0])
        return int(self.model.unembed(self.rows[prompt[0]][None]).argmax())


def _logits(top):
    """bf16 logits over 8 tokens: `top` maps token -> logit, the rest -4."""
    x = torch.full((8,), -4.0)
    for t, v in top.items():
        x[t] = v
    return x.to(torch.bfloat16)


def test_bf16_step():
    assert chip_smoke.bf16_step(1.0) == 2.0 ** -7
    assert chip_smoke.bf16_step(1.99) == 2.0 ** -7
    assert chip_smoke.bf16_step(-3.0) == 2.0 ** -6
    assert chip_smoke.bf16_step(20.0) == 2.0 ** -3
    for v in (1.0, 13.0, -200.0):
        step = chip_smoke.bf16_step(v)
        up = v + step if v > 0 else v - step
        # v +- one step is the next bf16 value; half a step rounds back
        assert torch.tensor(up, dtype=torch.bfloat16).item() == up
        assert torch.tensor((v + up) / 2, dtype=torch.bfloat16).item() == v


def test_equal_tokens_need_no_prefill():
    ex = _Stub({})
    ties = chip_smoke.check_first_tokens("t", ex, [[0], [1]],
                                         {"r0": 3, "r1": 5},
                                         {"r0": 3, "r1": 5})
    assert ties == [] and ex.calls == []


def test_a_one_step_near_tie_is_accepted_and_reported():
    step = chip_smoke.bf16_step(12.0)          # 2 ** -4
    ex = _Stub({0: _logits({2: 12.0 + step, 6: 12.0})})
    ties = chip_smoke.check_first_tokens("t", ex, [[0]], {"r0": 6},
                                         {"r0": 2})
    assert ex.calls == [0]
    assert len(ties) == 1
    tie = ties[0]
    assert tie["rid"] == "r0" and tie["tokens"] == [2, 6]
    assert tie["logits"] == [12.0 + step, 12.0] and tie["gap"] == step
    assert "unembed" not in vars(ex.model)           # restored


def test_an_exact_tie_is_accepted():
    ex = _Stub({0: _logits({1: 5.0, 4: 5.0})})
    ties = chip_smoke.check_first_tokens("t", ex, [[0]], {"r0": 1},
                                         {"r0": 4})
    assert ties[0]["gap"] == 0.0


@pytest.mark.parametrize("top,got,want", [
    ({2: 12.0 + 2 ** -3, 6: 12.0}, 6, 2),      # two steps apart
    ({2: 12.0 + 2 ** -4, 6: 12.0}, 5, 2),      # not the second best
    ({2: 12.0 + 2 ** -4, 6: 12.0}, 6, 6),      # equal: not a difference
])
def test_other_differences_fail(top, got, want):
    ex = _Stub({0: _logits(top)})
    if got == want:
        assert chip_smoke.check_first_tokens("t", ex, [[0]], {"r0": got},
                                             {"r0": want}) == []
        return
    with pytest.raises(AssertionError, match="not a near-tie"):
        chip_smoke.check_first_tokens("t", ex, [[0]], {"r0": got},
                                      {"r0": want})


def test_a_difference_without_its_prompt_fails():
    with pytest.raises(AssertionError, match="not a near-tie"):
        chip_smoke.check_first_tokens("t", _Stub({}), [[0]], {"late": 1},
                                      {"late": 2})
