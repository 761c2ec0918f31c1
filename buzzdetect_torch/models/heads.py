"""Classifier heads: small dense layers over 1024-d YAMNet embeddings.

Counterpart of ``buzzdetect_tpu/models/heads.py``: the model_general_v3 head
is a single linear Dense(13) (reference `models/model_general_v3/model.py:
18-30`), applied as one f32 matrix product. ``init_head`` is the JAX package's, numpy draws and
all, so a head trained by either package starts from the same weights.
"""

import numpy as np
import torch


def init_head(n_embeddings: int, n_classes: int, seed: int = 0):
    """A fresh (kernel, bias) pair as numpy arrays: standard normal kernel
    scaled by sqrt(1 / n_embeddings) from ``default_rng(seed)``, zero bias."""
    rng = np.random.default_rng(seed)
    std = float(np.sqrt(1.0 / n_embeddings))
    return {
        'head/kernel': (rng.standard_normal((n_embeddings, n_classes))
                        .astype(np.float32) * std),
        'head/bias': np.zeros(n_classes, np.float32),
    }


def apply_head(params: dict, embeddings: torch.Tensor) -> torch.Tensor:
    """(B, n_embeddings) embeddings -> (B, n_classes) linear activations.

    Exact f32 (TF32 off, see ops/common.exact_f32): head outputs are the
    user-visible scores and must hold the 1e-3 parity budget.
    """
    return (torch.matmul(embeddings.to(torch.float32), params['head/kernel'])
            + params['head/bias'])
