"""PyTorch port: one Conformer (L) train step on the card, at full width.

Needs a CUDA card; elsewhere it skips. Run it on the card with

    python -m pytest tests/test_torch_conformer_cuda.py -m cuda -q

One bf16 Adam step of ``conformer-l-ctc`` (17 blocks of 512, 8 heads,
kernel 32) at B 4 and about 16 s of audio a row (T' ~ 400), from the
benchmark's seeded weights, against its plain reference
(``portbench/reference/conformer.py``) at the configuration's operand
rounding, held to the train cell's limits
(``portbench/limits/train-conformer-l-b32-ls100.json``) by the
benchmark's own numbers (``harness/check.py``). The attention's counters
show that every block took the SDPA route (the memory-efficient backend
pinned: a fallback raises) and none the plain products.
"""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

pytestmark = pytest.mark.cuda
CELL = "train-conformer-l-b32-ls100"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def test_full_width_bf16_step_matches_the_reference_on_the_sdpa_route(dev):
    from deepspeech_tpu_torch.ops import attention
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)
    from portbench.entries.train_model import audio_conf, build, optimizer_of
    from portbench.harness import check
    from portbench.reference import conformer as ref

    cfg = _json("portbench", "configs", "conformer-l-ctc.json")
    limits = _json("portbench", "limits", f"{CELL}.json")
    seed = 2 ** 31 + 77
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.tensor([264000, 250000, 231000, 198000], device=dev)
    s = 264400
    audio = torch.randn(4, s, generator=g, device=dev) * 0.1
    audio = audio * (torch.arange(s, device=dev)[None] < lens[:, None])
    batch = {"audio": audio, "audio_lengths": lens.int(),
             "targets": torch.randint(1, 30, (4, 200), generator=g,
                                      device=dev, dtype=torch.int32),
             "target_lengths": torch.tensor([200, 190, 170, 150],
                                            device=dev, dtype=torch.int32),
             "valid": torch.ones(4, device=dev)}

    model = build(cfg, ref.make_weights(cfg, seed, dev), dev)
    opt = optimizer_of(cfg)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, StepConfig(audio_conf=audio_conf(cfg)))
    named = list(model.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    sdpa, plain = attention.mhsa_sdpa_launches, attention.mhsa_plain_launches
    m = step(state, batch)
    prog = {"loss": [float(m["loss"])],
            "grad": {n: float((mu / 0.1).double().norm()) for (n, _), mu in
                     zip(named, state.opt_state["mu"])},
            "change": {n: float((p.detach() - start[n]).double().norm())
                       for n, p in named}}
    assert attention.mhsa_sdpa_launches - sdpa == cfg["layers"]
    assert attention.mhsa_plain_launches == plain
    assert not bool(m["step_skipped"])
    del model, state, step, start, m
    torch.cuda.empty_cache()
    want = ref.train_steps(ref.make_weights(cfg, seed, dev), [batch], [None],
                           cfg, "bfloat16")
    numbers = check.train_numbers(prog, want)
    print(numbers)
    correct, table = check.verdict(numbers, limits)
    assert correct, table
