"""What a kernel's autograd function asks the running backward: which of
its parameters' gradients the engine will use (``torch.autograd.grad`` to
an upstream tensor uses none of them, though ``needs_input_grad`` is true
for every parameter that takes a gradient)."""

from __future__ import annotations

import torch


def grad_node(t):
    """The autograd node that receives ``t``'s gradient (its
    ``AccumulateGrad`` for a leaf), or None where ``t`` takes none."""
    if t is None or not t.requires_grad:
        return None
    return torch.autograd.graph._get_grad_fn_or_grad_acc(t)


def will_run(node) -> bool:
    """Whether the running backward passes a gradient on to ``node``: true
    under ``loss.backward()``, false for a weight under
    ``torch.autograd.grad(loss, [upstream])``.  The engine refuses the
    query for a leaf that ``torch.autograd.grad`` asks for, which runs."""
    if node is None:
        return False
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError:  # a leaf captured by torch.autograd.grad
        return True
