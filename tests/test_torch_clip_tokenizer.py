"""The port's ClipBPETokenizer (its own copy) against the JAX package's,
on the prompts and the synthesized byte-level vocabulary of
tests/test_clip_tokenizer.py (the OpenAI vocab file is not available
offline): the same ids, exactly."""

import json

import numpy as np
import pytest

from autodiffusion_tpu.models.clip_text import \
    ClipBPETokenizer as JaxTokenizer
from autodiffusion_tpu_torch.models import ClipBPETokenizer
from autodiffusion_tpu_torch.models.clip_text import _bytes_to_unicode
from test_clip_tokenizer import MERGES, PROMPTS


def write_vocab(d):
    """vocab.json and merges.txt of a complete byte-level base vocabulary
    (256 chars, their '</w>' variants, a few merges, the specials)."""
    chars = list(_bytes_to_unicode().values())
    tokens = chars + [c + "</w>" for c in chars] + \
        ["".join(m) for m in MERGES] + ["<|startoftext|>", "<|endoftext|>"]
    vocab_path, merges_path = d / "vocab.json", d / "merges.txt"
    vocab_path.write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    merges_path.write_text("#version: 0.2\n" + "\n".join(
        f"{a} {b}" for a, b in MERGES) + "\n")
    return str(vocab_path), str(merges_path)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    paths = write_vocab(tmp_path_factory.mktemp("clip_vocab"))
    return (ClipBPETokenizer.from_files(*paths),
            JaxTokenizer.from_files(*paths))


@pytest.mark.parametrize("prompt", PROMPTS)
def test_ids_match_jax(pair, prompt):
    ours, theirs = pair
    np.testing.assert_array_equal(ours([prompt]), theirs([prompt]))


def test_batch_padding_and_truncation_match_jax(pair):
    ours, theirs = pair
    batch = ["", "of the", "word " * 100]
    got = ours(batch)
    assert got.shape == (3, 77) and got.dtype == np.int32
    np.testing.assert_array_equal(got, theirs(batch))
    assert got[0, 0] == ours.sot and got[0, 1] == ours.eot
    assert got[2, -1] == ours.eot
