"""Seeded random weights, made on the device in a few large draws.

Weight matrices and kernels are uniform in +-1/sqrt(fan_in) (a KPConv's
(K, Cin, Cout) over Cin * Cout), biases uniform in +-0.01, norm scales 1,
running statistics (0, 1).  With ``jitter``, every KPConv's kernel points
are rotated about a random axis and jittered by 1% of their radius, as a
released checkpoint carries them.  The same (model layout, seed) gives the
same state on any module with these names, so the program and the
reference each build theirs from the seed.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness.frames import mix


@torch.no_grad()
def seeded_state(model: torch.nn.Module, seed: int, device, jitter: bool = False) -> dict:
    state = {k: v.detach().to(device) for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    mats = [k for k, p in params.items() if p.ndim >= 2]
    biases = [k for k, p in params.items() if p.ndim < 2 and k.endswith("bias")]
    gen = torch.Generator(device).manual_seed(mix(seed, 3))
    sizes = [params[k].numel() for k in mats + biases]
    u = torch.rand(sum(sizes), generator=gen, device=device).mul_(2).sub_(1)
    for k, chunk in zip(mats + biases, torch.split(u, sizes)):
        p = params[k]
        scale = 1.0 / math.sqrt(math.prod(p.shape[1:])) if p.ndim >= 2 else 0.01
        state[k] = (chunk * scale).reshape(p.shape)
    for k, p in params.items():
        if k not in state or (p.ndim < 2 and not k.endswith("bias")):
            state[k] = torch.ones(p.shape, device=device)
    for k in state:
        if k.endswith("running_mean"):
            state[k] = torch.zeros_like(state[k])
        elif k.endswith("running_var"):
            state[k] = torch.ones_like(state[k])
    if jitter:
        names = [k for k in state if k.endswith("kernel_points")]
        kp = torch.stack([state[k] for k in names]).double()  # (L, K, 3)
        n = len(names)
        axis = torch.randn(n, 3, generator=gen, device=device, dtype=torch.float64)
        axis = axis / axis.norm(dim=-1, keepdim=True)
        th = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * 2 * math.pi
        zero = torch.zeros_like(axis[:, 0])
        k3 = torch.stack([zero, -axis[:, 2], axis[:, 1], axis[:, 2], zero, -axis[:, 0],
                          -axis[:, 1], axis[:, 0], zero], -1).reshape(n, 3, 3)
        eye = torch.eye(3, dtype=torch.float64, device=device)
        rot = eye + th.sin()[:, None, None] * k3 + (1 - th.cos())[:, None, None] * (k3 @ k3)
        noise = torch.randn(kp.shape, generator=gen, device=device, dtype=torch.float64)
        noise = noise * 0.01 * kp.norm(dim=-1).amax(-1)[:, None, None]
        out = (kp @ rot.transpose(1, 2) + noise).float()
        for i, k in enumerate(names):
            state[k] = out[i]
    return state
