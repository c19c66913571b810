"""Adam whose step count never leaves the device.

``torch.optim.Adam`` keeps each parameter's step count in a CPU tensor
and reads it into Python at every step to form the bias corrections
(its ``capturable`` form, which keeps the count on the device, refuses
CPU parameters).  A learn burst then reads a value into Python at every
gradient step, which ``analysis.no_host_sync`` counts on every device.

:class:`DeviceAdam` is ``torch.optim.Adam`` (the same hyperparameters,
state names and ``state_dict``, so checkpoints, snapshots and the mesh's
leaf names are unchanged) with its own ``step``: the count is a 0-d f32
tensor on the parameter's device, and the bias corrections are formed
there in float64 from it, as Python forms them from the count in
double.  The moments update as in torch's own Adam (``lerp``, then
``mul`` and ``addcmul``), the denominator is ``sqrt(v) / sqrt(bc2) +
eps`` with f32 operands, and the parameter moves by ``(m * -lr / bc1) /
denom``, the order of ``addcdiv``'s CPU kernel.  So on the CPU it gives
torch's Adam bit for bit.  Every parameter of a group steps together
(the DDPG step gives each a gradient), so the group's corrections come
from its first count.  A count restored on another device (a checkpoint
written by torch's Adam keeps it on the CPU) is moved to its parameter's
device at the next step.
"""
from __future__ import annotations

from typing import List

import torch


class DeviceAdam(torch.optim.Adam):
    """``torch.optim.Adam(params, lr, betas, eps)`` without host reads."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("DeviceAdam takes no closure")
        for group in self.param_groups:
            params: List[torch.Tensor] = []
            grads, exp_avgs, exp_avg_sqs, steps = [], [], [], []
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32,
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                elif st["step"].device != p.device:
                    st["step"] = st["step"].to(p.device)
                params.append(p)
                grads.append(p.grad)
                exp_avgs.append(st["exp_avg"])
                exp_avg_sqs.append(st["exp_avg_sq"])
                steps.append(st["step"])
            if not params:
                continue
            beta1, beta2 = group["betas"]
            torch._foreach_add_(steps, 1.0)
            torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
            torch._foreach_mul_(exp_avg_sqs, beta2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
            count = steps[0].double()
            bc1 = 1 - torch.pow(beta1, count)
            bc2 = 1 - torch.pow(beta2, count)
            neg_step_size = (-group["lr"] / bc1).float()
            bc2_sqrt = bc2.sqrt().float()
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_mul(exp_avgs, neg_step_size)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(params, upd)
        return None
