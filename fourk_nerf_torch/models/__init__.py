"""Scene models (radiance fields) and the SR stack.

:func:`model_module` is the reference driver's choice of scene model
(frozoul/4K-NeRF run.py:286-313): NDC scenes take DirectMPIGO (DirectQVGO
with ``mode_type == 'adain_vq'``), unbounded inward-facing ones
DirectContractedVoxGO, the rest DirectVoxGO. DirectBiVoxGO (``dbvgo``) is
dormant, as in the reference: no driver chooses it.
"""


def model_module(ndc: bool, unbounded_inward: bool = False,
                 mode_type: str = ""):
    from fourk_nerf_torch.models import dcvgo, dmpigo, dvgo, dvqgo

    if ndc:
        return dvqgo if mode_type == "adain_vq" else dmpigo
    if unbounded_inward:
        return dcvgo
    return dvgo
