"""The asset-prep tools of the port (``python -m smpltpu_torch.tools.<name>``)
against the scripts they twin, ``scripts/npz_fixer.py`` and
``scripts/convert_gmm_to_avatar.py``, on the inputs that
``tests/test_scripts.py`` builds: both ``main``s called in this process,
their output files byte for byte equal. An npz is a zip archive that
stamps each member with the time of writing, so the clock is held still
while both write."""

import os
import pickle
import time

import numpy as np
import pytest

from smpltpu_torch.tools import convert_gmm_to_avatar, npz_fixer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def scripts(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import convert_gmm_to_avatar as ref_gmm
    import npz_fixer as ref_fixer
    return ref_fixer, ref_gmm


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("explicit_out", [False, True])
def test_npz_fixer_matches_script(tmp_path, monkeypatch, scripts,
                                  explicit_out):
    """The kintree fix, to <name>_fixed.npz or to the named file: the same
    bytes as the script's, the root's parent -1."""
    ref_fixer, _ = scripts
    kintree = np.array([[0, 0, 1], [0, 1, 2]], dtype=np.uint32)
    outs = {}
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    for tag, tool in (("ref", ref_fixer), ("port", npz_fixer)):
        d = tmp_path / tag
        d.mkdir()
        np.savez(d / "raw.npz", kintree_table=kintree,
                 v_template=np.zeros((4, 3)))
        argv = [str(d / "raw.npz")] + ([str(d / "out.npz")] if explicit_out
                                       else [])
        assert tool.main(argv) == 0
        outs[tag] = d / ("out.npz" if explicit_out else "raw_fixed.npz")
    assert _bytes(outs["port"]) == _bytes(outs["ref"])
    fixed = np.load(outs["port"])
    assert fixed["kintree_table"][0, 0] == -1
    np.testing.assert_array_equal(fixed["v_template"], np.zeros((4, 3)))


def test_convert_gmm_matches_script(tmp_path, scripts):
    """The GMM pickle to the avatar text format: the same bytes as the
    script's, and it reads back."""
    _, ref_gmm = scripts
    rng = np.random.default_rng(0)
    k, d = 3, 69
    means = rng.normal(size=(k, d))
    covs = np.stack([np.eye(d) * (i + 1) for i in range(k)])
    weights = np.array([0.5, 0.3, 0.2])
    src = tmp_path / "gmm.pkl"
    with open(src, "wb") as f:
        pickle.dump({"means": means, "covars": covs, "weights": weights}, f)
    dst = {tag: tmp_path / f"{tag}_pose_prior.txt" for tag in ("ref", "port")}
    assert ref_gmm.main([str(src), str(dst["ref"])]) == 0
    assert convert_gmm_to_avatar.main([str(src), str(dst["port"])]) == 0
    assert _bytes(dst["port"]) == _bytes(dst["ref"])
    from smpltpu_torch.io import load_pose_prior_txt
    prior = load_pose_prior_txt(str(dst["port"]))
    np.testing.assert_allclose(prior["means"], means, rtol=1e-12)
    np.testing.assert_allclose(prior["weights"], weights, rtol=1e-12)


@pytest.mark.parametrize("which", ["npz_fixer", "convert_gmm_to_avatar"])
def test_usage_matches_script(capsys, scripts, which):
    """Too few arguments: the script's usage line and exit code 1."""
    ref = dict(zip(("npz_fixer", "convert_gmm_to_avatar"), scripts))[which]
    port = {"npz_fixer": npz_fixer,
            "convert_gmm_to_avatar": convert_gmm_to_avatar}[which]
    assert ref.main([]) == 1
    want = capsys.readouterr().out
    assert port.main([]) == 1
    assert capsys.readouterr().out == want and want.startswith("Usage")
