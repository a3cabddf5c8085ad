"""The port's synthetic data stream (``repro_torch/data/pipeline.py``)
against the JAX package's: for the same seed the same token, label and
modality arrays, batch after batch, for every registered architecture
(llava's patch prefix and seamless's encoder frames included).  Exact."""
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.data import pipeline as JP
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.data import pipeline as TP


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_batches_match_jax(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    for seed, t, b in ((0, 12, 2), (7, 33, 3)):
        shape = InputShape("t", t, b, "train")
        jit = JP.train_batches(jcfg, shape, JP.DataConfig(seed=seed))
        tit = TP.train_batches(tcfg, shape, TP.DataConfig(seed=seed))
        for _ in range(3):
            want, got = next(jit), next(tit)
            assert set(got) == set(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key])
        assert TP.text_len(tcfg, shape) == JP.text_len(jcfg, shape)
        assert TP._modality_len(tcfg, shape) == JP._modality_len(jcfg, shape)
    assert ("modality_emb" in want) == bool(jcfg.modality_embed_dim)


def test_batch_override_and_labels():
    cfg = get_smoke_config("qwen2-0.5b")
    batch = next(TP.train_batches(cfg, SHAPES["train_4k"],
                                  batch_override=1))
    assert batch["tokens"].shape == (1, 4096)
    assert batch["tokens"].dtype == np.int32
    np.testing.assert_array_equal(batch["labels"][:, :-1],
                                  batch["tokens"][:, 1:])
    assert (batch["labels"][:, -1] == -1).all()
    assert batch["tokens"].max() < cfg.vocab_size


def test_shapes_are_the_jax_packages():
    assert SHAPES.keys() == JSHAPES.keys()
    for name, shape in SHAPES.items():
        assert tuple(shape.__dict__.values()) == \
            tuple(JSHAPES[name].__dict__.values())
