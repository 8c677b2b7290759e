"""The port's WavLM extractor (``jmt_tpu_torch/data/wavlm_extract.py``)
against the JAX package's, float32 on the CPU.

Same wav, same weights (the port's state dict, which the JAX converter
reads): ``features`` over several windows and ``per_frame`` within atol
1e-5 of JAX's; the windowed output covers every frame and repeats
bitwise; ``extract_tree`` writes the files JAX's ``extract_tree`` writes
from the same ``torch.save``d state dict, values within 1e-5, and the
port's wavLM store reads them back; ``load_torch_checkpoint`` infers
JAX's geometry; a file that pickles a module is refused; the command line
runs with ``--device cpu`` and the default device is the card.
"""
import os

import numpy as np
import pytest
import torch

from jmt_tpu.data import wavlm_extract as jextract
from jmt_tpu.models import wavlm as jwavlm
from jmt_tpu_torch.data import wavlm_extract as extract
from jmt_tpu_torch.data.audio_io import write_wav
from jmt_tpu_torch.data.datasets import WavlmFeatureStore
from jmt_tpu_torch.models.wavlm import WavLMConfig
from test_torch_wavlm import TINY, jax_cfg, model

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    m = model(TINY, 3)
    params = jwavlm.wavlm_params_from_torch(m.state_dict(), jax_cfg(TINY))
    return m, params


def _wav(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * rng.normal(size=int(seconds * 16000))).astype(np.float32)


def test_features_and_per_frame_match_jax(tiny):
    m, params = tiny
    ex = extract.WavLMExtractor(m, window_s=0.05, overlap_s=0.01,
                                device="cpu")
    jex = jextract.WavLMExtractor(params, jax_cfg(TINY), window_s=0.05,
                                  overlap_s=0.01)
    wav = _wav(0.33, 1)
    got, want = ex.features(wav), jex.features(wav)
    assert got.shape == want.shape and got.shape[0] > 3 * ex.win_frames
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ex.per_frame(wav, 11, 30.0),
                               jex.per_frame(wav, 11, 30.0), rtol=0,
                               atol=1e-5)


def test_windowed_covers_every_frame_and_repeats(tiny):
    m, _ = tiny
    ex = extract.WavLMExtractor(m, window_s=0.05, overlap_s=0.01,
                                device="cpu")
    wav = _wav(0.33, 2)
    out = ex.features(wav)
    np.testing.assert_array_equal(out, ex.features(wav))
    assert (np.abs(out).sum(axis=1) > 0).all()
    assert out.shape[0] == TINY.n_frames(len(wav))
    with pytest.raises(ValueError, match="overlap_s"):
        extract.WavLMExtractor(m, window_s=0.02, overlap_s=0.01,
                               device="cpu")


def _wav_dir(tmp_path):
    wav_dir = tmp_path / "wavs"
    rng = np.random.default_rng(2)
    write_wav(str(wav_dir / "vid_a.wav"),
              rng.normal(0, 0.1, 44100).astype(np.float32), 44100)
    write_wav(str(wav_dir / "vid_b.wav"),
              rng.normal(0, 0.1, 22050).astype(np.float32), 44100)
    return wav_dir


def test_extract_tree_writes_the_jax_files(tiny, tmp_path):
    m, _ = tiny
    ckpt = tmp_path / "wavlm_tiny.pt"
    torch.save(m.state_dict(), ckpt)
    wav_dir = _wav_dir(tmp_path)
    kw = dict(fps=10.0, window_s=0.2, overlap_s=0.01, verbose=False)
    n = extract.extract_tree(str(ckpt), str(wav_dir), str(tmp_path / "port"),
                             cfg=TINY, device="cpu", **kw)
    jn = jextract.extract_tree(str(ckpt), str(wav_dir),
                               str(tmp_path / "jax"), cfg=jax_cfg(TINY), **kw)
    assert n == jn == 10 + 5  # 1.0 s and 0.5 s at 10 fps
    for vid in ("vid_a", "vid_b"):
        files = sorted(os.listdir(tmp_path / "port" / vid))
        assert files == sorted(os.listdir(tmp_path / "jax" / vid))
        assert "1.npy" in files
        for f in files:
            got = np.load(tmp_path / "port" / vid / f)
            assert got.shape == (TINY.hidden_size,)
            np.testing.assert_allclose(
                got, np.load(tmp_path / "jax" / vid / f), rtol=0, atol=1e-5)
    store = WavlmFeatureStore(str(tmp_path / "port"), dim=TINY.hidden_size)
    got = store.lookup_batch([["/any/vid_a/3.wav", "/any/vid_b/2.wav"]])
    np.testing.assert_array_equal(
        got[0, 1], np.load(tmp_path / "port" / "vid_b" / "2.npy"))


def test_checkpoint_geometry_is_inferred_like_jax(tmp_path):
    cfg = WavLMConfig(hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=4, intermediate_size=16,
                      conv_dim=(8,) * 7, conv_bias=True)
    src = model(cfg, 6)
    path = tmp_path / "wavlm.pt"
    torch.save({f"wavlm.{k}": v for k, v in src.state_dict().items()}, path)
    loaded, got = extract.load_torch_checkpoint(str(path))
    assert got == cfg
    params, jcfg = jextract.load_torch_checkpoint(str(path))
    assert jcfg == jax_cfg(cfg)
    wav = np.random.default_rng(6).normal(size=(1, 2000)).astype(np.float32)
    with torch.no_grad():
        out = loaded(torch.from_numpy(wav)).numpy()
    ref = np.asarray(jwavlm.wavlm_apply(params, wav, jcfg))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_a_pickled_module_is_refused(tiny, tmp_path):
    path = tmp_path / "module.pt"
    torch.save(tiny[0], path)
    with pytest.raises(ValueError, match="state_dict"):
        extract.load_torch_checkpoint(str(path), TINY)


def test_command_line_on_the_cpu_and_the_card_by_default(tiny, tmp_path,
                                                          monkeypatch,
                                                          capsys):
    m, _ = tiny
    cfg = WavLMConfig(hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=4, intermediate_size=16,
                      conv_dim=(8,) * 7)
    ckpt = tmp_path / "wavlm.pt"
    torch.save(model(cfg, 7).state_dict(), ckpt)
    wav_dir = _wav_dir(tmp_path)
    argv = ["--checkpoint", str(ckpt), "--wav-dir", str(wav_dir),
            "--dest", str(tmp_path / "feats"), "--fps", "10"]
    assert extract.main(argv + ["--device", "cpu"]) == 0
    assert "wrote 15 per-frame features" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "feats" / "vid_a")) == 10
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        extract.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        extract.WavLMExtractor(m)
