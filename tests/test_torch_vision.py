"""LLaVA-NeXT-Mistral-7B ``.reduced()`` in the port against the reference,
on the CPU (2 layers, d 256, 4 heads on 4, hd 64, 32 image rows ahead of
the text, float32): ``Model.init``, a bf16 tree carried across bit for
bit, train-mode logits (the image rows' logits dropped), prefill of the
image rows and the prompt into a cache of V + T positions and decode at V
+ t, decode against the port's own full forward, a train step, and
``serve()``, whose cache holds the prefix (the reference's CLI sizes its
cache without it and fails; its model API is what both follow here).
Image rows are numpy draws from a seed, handed to both packages.  The
checks and their tolerances are ``tests/test_torch_encdec.py``'s."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

from test_torch_encdec import (  # noqa: E402
    check_bf16_round_trip, check_init, check_prefill_and_decode,
    check_serve, check_train_logits, check_train_step)

LLAVA = "llava-next-mistral-7b"


def test_llava_builds_with_its_vision_prefix():
    cfg = get_arch(LLAVA)
    assert cfg.vision_tokens == 2880 and cfg.encoder_layers == 0
    assert build_model(cfg).cfg is cfg


def test_llava_init_gives_the_reference_weights():
    check_init(LLAVA, ["groups/sub0/mixer/wq", "groups/sub0/ffn/wg",
                       "lm_head"])


def test_llava_bf16_tree_round_trips_bit_for_bit():
    check_bf16_round_trip(LLAVA)


def test_llava_train_logits_match_the_reference():
    check_train_logits(LLAVA)


def test_llava_prefill_and_decode_after_the_prefix_match_the_reference():
    check_prefill_and_decode(LLAVA)


def test_llava_train_step_matches_the_reference():
    check_train_step(LLAVA)


def test_llava_serve_gives_the_reference_tokens():
    check_serve(LLAVA)
