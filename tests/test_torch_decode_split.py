"""Host-side planning of the decode attention kernel: how the wrapper cuts
the cache's slots into one chunk per CTA and sizes the partials'
workspace.  The kernel itself runs only on the card (``chip_smoke.py``)."""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

import pytest

from repro_torch.kernels.decode_attention import ops

KERNEL_SRC = (Path(ops.__file__).parent / "csrc" / "decode_attention.cu")


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("kv", [1, 2, 8])
def test_chunks_cover_every_slot_once(kv, b):
    g, d = 7, 64
    for s in range(1, 4097):
        plan = ops.plan_split(b, s, kv * g, kv, d)
        # the kernel's cut: CTA i takes slots [i * chunk, (i + 1) * chunk)
        bounds = [(i * plan.chunk, min((i + 1) * plan.chunk, s))
                  for i in range(plan.n_split)]
        slots = [j for start, stop in bounds for j in range(start, stop)]
        assert slots == list(range(s)), s
        assert all(0 < stop - start <= plan.chunk for start, stop in bounds)
        assert 1 <= plan.chunk <= ops.MAX_CHUNK
        # the kernel's own rule for the count of chunks
        assert plan.n_split == (s + plan.chunk - 1) // plan.chunk
        assert plan.grid == (plan.n_split, kv, b)
        assert plan.workspace_shape == (b, kv, plan.n_split, g, d + 2)


@pytest.mark.parametrize("s,kv,ctas", [(256, 2, 16), (4096, 2, 128),
                                       (40, 2, 4), (1, 2, 2)])
def test_long_caches_fill_the_card(s, kv, ctas):
    """The serving cache (S=256, KV=2) takes 16 CTAs of 32 slots; a 4096-slot
    cache 128 CTAs of 64, within one wave of the H100's 132 SMs."""
    plan = ops.plan_split(1, s, 7 * kv, kv, 64)
    n_split, kv_, b = plan.grid
    assert n_split * kv_ * b == ctas


def test_max_chunk_matches_the_kernel():
    src = KERNEL_SRC.read_text()
    assert int(re.search(r"kMaxChunk = (\d+);", src).group(1)) == \
        ops.MAX_CHUNK


def test_launcher_argtypes_match_the_c_entry_point():
    """The ctypes signature set once in ``_launcher`` against the C
    declaration: pointers, then ints, then the stream."""
    src = KERNEL_SRC.read_text()
    decl = re.search(r'extern "C" int decode_attention_launch\((.*?)\)',
                     src, re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in a else ctypes.c_int
             for a in decl.split(",")]
    assert kinds == ops.ARGTYPES


def test_launcher_at_argtypes_match_the_c_entry_point():
    """The position read on the card: the one entry point takes ``pos_at``
    as the pointer after ``counters`` and still takes ``pos`` by value (the
    wrapper passes a tensor's address, or null and the host int)."""
    src = KERNEL_SRC.read_text()
    decl = re.search(r'extern "C" int decode_attention_launch\((.*?)\)',
                     src, re.S).group(1)
    args = [a.split()[-1].lstrip("*") for a in decl.split(",")]
    assert args[6:9] == ["counters", "pos_at", "B"]
    assert ops.ARGTYPES[7] == ctypes.c_void_p and "pos" in args
    assert "decode_attention_launch_at" not in src
