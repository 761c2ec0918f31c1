"""Classifier heads: small dense layers over 1024-d YAMNet embeddings.

Counterpart of ``buzzdetect_tpu/models/heads.py``: the model_general_v3 head
is a single linear Dense(13) (reference `models/model_general_v3/model.py:
18-30`), applied as one f32 matrix product.
"""

import torch


def apply_head(params: dict, embeddings: torch.Tensor) -> torch.Tensor:
    """(B, n_embeddings) embeddings -> (B, n_classes) linear activations.

    Exact f32 (TF32 off, see ops/sepconv.exact_f32): head outputs are the
    user-visible scores and must hold the 1e-3 parity budget.
    """
    return (torch.matmul(embeddings.to(torch.float32), params['head/kernel'])
            + params['head/bias'])
