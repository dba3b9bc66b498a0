"""Loss functions (port of ``training/losses.py``): the classifier's
``labels=`` switch, MSE for num_labels == 1 (regression) else
cross-entropy, both in fp32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MSELoss(logits.view(-1), labels.view(-1))."""
    return torch.mean(torch.square(logits.reshape(-1).float()
                                   - labels.reshape(-1).float()))


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss(logits.view(-1, C), labels.view(-1))."""
    num_classes = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, num_classes).float(),
                           labels.reshape(-1).long())


def sequence_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                                 num_labels: int) -> torch.Tensor:
    """num_labels == 1 → MSE (regression), else cross-entropy."""
    if num_labels == 1:
        return mse_loss(logits, labels)
    return cross_entropy_loss(logits, labels)
