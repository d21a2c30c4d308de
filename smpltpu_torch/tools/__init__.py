"""Asset-preparation tools (twins of ``scripts/npz_fixer.py`` and
``scripts/convert_gmm_to_avatar.py``) on the port's own io:

    python -m smpltpu_torch.tools.npz_fixer <model.npz> [out.npz]
    python -m smpltpu_torch.tools.convert_gmm_to_avatar gmm_08.pkl pose_prior.txt
"""
