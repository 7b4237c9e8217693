"""``adt-torch selftest`` (fid/selftest.py) and the port's own copy of the
independent pytorch_fid mirror (fid/torch_mirror.py), on the CPU.

With a synthesized pytorch_fid-layout checkpoint (synthesize_pt_inception)
the five checks run as adt selftest's do (tests/test_inception_parity.py):
the consistency checks pass, and the digest is not the genuine file's, so
``passed`` is true and ``certified`` false. A file with a key dropped
fails the strict load; --ref_batch without --ref_stats (or the reverse)
is refused before any work. The port's mirror is the JAX package's,
module for module: the same state dict gives the same features (exactly:
the same torch graph on the same CPU).
"""

import json
import warnings

import numpy as np
import pytest
import torch

from autodiffusion_tpu.fid.torch_mirror import \
    build_torch_mirror as jax_side_mirror
from autodiffusion_tpu_torch.cli.main import main
from autodiffusion_tpu_torch.fid import synthesize_pt_inception
from autodiffusion_tpu_torch.fid.selftest import (GENUINE_SHA256_PREFIX,
                                                  run_selftest)
from autodiffusion_tpu_torch.fid.torch_mirror import (build_torch_mirror,
                                                      load_mirror_state)


@pytest.fixture(scope="module")
def fake_pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("incep") / "pt_inception_fake.pth"
    torch.save(synthesize_pt_inception(0), path)
    return path


def test_selftest_on_synthesized_weights_passes_uncertified(fake_pth,
                                                            capsys):
    # an 8-image fixture leaves the 2048-dim covariances rank-deficient:
    # scipy's sqrtm warning is inherent, not a defect
    from scipy.linalg import LinAlgWarning

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", LinAlgWarning)
        rc = main(["selftest", "--device", "cpu", "--inception_path",
                   str(fake_pth), "--n_fixture", "8", "--batch_size", "4"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, got
    assert got["passed"] is True and got["certified"] is False
    checks = got["checks"]
    assert not checks["weights_sha256"]["genuine"]
    assert not checks["weights_sha256"]["value"].startswith(
        GENUINE_SHA256_PREFIX)
    assert checks["port_load"]["ok"] and checks["torch_mirror_load"]["ok"]
    for size in (299, 64):
        rep = checks[f"feature_parity_{size}"]
        assert rep["ok"] and max(v for k, v in rep.items()
                                 if k != "ok") < 1e-3
    assert checks["fid_reproduction"]["ok"], checks
    assert "ref_batch_fid" not in checks


@pytest.mark.parametrize("drop", ["Mixed_6b.branch1x1.conv.weight",
                                  "Mixed_7c.branch_pool.bn.running_var",
                                  "fc.bias"])
def test_dropped_key_fails_the_strict_load(fake_pth, tmp_path, drop):
    sd = torch.load(fake_pth, weights_only=True)
    del sd[drop]
    bad = tmp_path / "bad.pth"
    torch.save(sd, bad)
    with pytest.raises((KeyError, RuntimeError, ValueError)):
        run_selftest(str(bad), device="cpu", n_fixture=4, batch_size=4)
    with pytest.raises(ValueError, match="missing keys"):
        load_mirror_state(build_torch_mirror(), str(bad))


def test_selftest_rejects_lone_ref_batch(fake_pth, tmp_path):
    rb = str(tmp_path / "rb.npz")
    np.savez(rb, arr_0=np.zeros((4, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="together"):
        run_selftest(str(fake_pth), ref_batch=rb, device="cpu")
    with pytest.raises(ValueError, match="together"):
        run_selftest(str(fake_pth), ref_stats=rb, device="cpu")


def test_mirror_is_the_jax_packages_mirror(fake_pth):
    """The port's copy and the JAX package's mirror: the same keys, and the
    same features from the same checkpoint."""
    ours = load_mirror_state(build_torch_mirror(), str(fake_pth))
    theirs = jax_side_mirror()
    theirs.load_state_dict(torch.load(fake_pth, weights_only=True),
                           strict=False)
    assert ours.state_dict().keys() == theirs.state_dict().keys()
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, 3, 299, 299)).astype(np.float32))
    with torch.no_grad():
        a, b = ours(x), theirs(x)
    for k in ("pool3", "spatial", "logits"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
