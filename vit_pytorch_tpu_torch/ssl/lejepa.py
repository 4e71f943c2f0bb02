"""LeJEPA (reference lejepa.py:188-320), port of ``vit_pytorch_tpu/ssl/lejepa.py``:
the MSE between the local views' projections and the other global view's,
plus SIGReg, the sketched isotropic-Gaussian regulariser.

One encoder (a Dino :class:`~.dino.NetWrapper`), no teacher and no EMA: the
two local views run as one batch with gradients, the two global views as
one batch under ``torch.no_grad()`` (JAX :125-136).  SIGReg's empirical
characteristic function takes cos and sin, as the JAX package computes it.
Its slice directions are ``sigreg_projs`` or are drawn on the projections'
device from a generator seeded by one host draw from ``generator``.

``state_dict()``: ``encoder.net.*`` and ``encoder.projector.net.*``, the
layout ``utils/convert.py::convert_lejepa`` reads.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..utils.helpers import default_device, pair
from .dino import NetWrapper, make_views


def sigreg_loss(x, num_slices: int = 1024, domain: Tuple[float, float] = (-5.0, 5.0), num_knots: int = 17,
                projs: Optional[torch.Tensor] = None, *, generator: Optional[torch.Generator] = None):
    """reference lejepa.py:42-77 (real-valued).  ``projs``: (num_slices,
    dim) unit slice directions, else drawn from ``generator`` (on its
    device) and normalised.  The projection runs in the dtype JAX promotes
    ``x`` and the float32 directions to."""
    dim = x.shape[-1]
    if projs is None:
        device = x.device if generator is None else generator.device
        projs = torch.randn((num_slices, dim), generator=generator, device=device).to(x.device)
        projs = projs / torch.linalg.vector_norm(projs, dim=-1, keepdim=True).clamp_min(1e-6)
    dtype = torch.promote_types(x.dtype, projs.dtype)
    t = torch.linspace(domain[0], domain[1], num_knots, device=x.device)
    exp_f = torch.exp(-0.5 * t.square())
    x_t = torch.einsum("...d,md->...m", x.to(dtype), projs.to(dtype)).reshape(-1, num_slices)
    x_t = x_t[..., None] * t  # (n, m, k)
    ecf_re = torch.cos(x_t).mean(dim=0)
    ecf_im = torch.sin(x_t).mean(dim=0)
    err = ((ecf_re - exp_f).square() + ecf_im.square()) * exp_f
    return torch.trapezoid(err, t, dim=-1).mean()


class LeJEPA(nn.Module):
    """reference lejepa.py:188 — same constructor; ``device``, ``dtype`` and
    ``generator`` place and seed the projector, as
    :class:`~.dino.Dino`'s."""

    def __init__(
        self, net: nn.Module, image_size, hidden_layer="transformer", projection_hidden_size: int = 256,
        num_classes_K: int = 65336, projection_layers: int = 4, local_upper_crop_scale: float = 0.4,
        global_lower_crop_scale: float = 0.5, target_loss_weight: float = 1.0, sigreg_loss_weight: float = 1.0,
        sigreg_num_slices: int = 1024, sigreg_domain: Tuple[float, float] = (-5.0, 5.0), sigreg_num_knots: int = 17,
        augment_fn: Optional[Callable] = None, augment_fn2: Optional[Callable] = None, *,
        device=None, dtype=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.image_size = image_size
        self.local_upper_crop_scale, self.global_lower_crop_scale = local_upper_crop_scale, global_lower_crop_scale
        self.target_loss_weight, self.sigreg_loss_weight = target_loss_weight, sigreg_loss_weight
        self.sigreg_num_slices, self.sigreg_domain, self.sigreg_num_knots = (
            sigreg_num_slices, sigreg_domain, sigreg_num_knots)
        self.augment_fn, self.augment_fn2 = augment_fn, augment_fn2
        self.encoder = NetWrapper(
            net, num_classes_K, projection_hidden_size, projection_layers, layer=hidden_layer,
            input_shape=(getattr(net, "channels", 3), *pair(image_size)), device=default_device(device),
            dtype=dtype, generator=generator,
        )

    def make_views(self, x, generator: Optional[torch.Generator] = None):
        """As :meth:`~.dino.Dino.make_views`."""
        return make_views(self, x, generator)

    def forward(self, x, *, generator: Optional[torch.Generator] = None, views=None,
                sigreg_projs: Optional[torch.Tensor] = None):
        """One LeJEPA forward (JAX ``lejepa_forward``, :100-154): the loss.
        ``views`` and ``sigreg_projs`` stand for the draws from
        ``generator`` (a CPU generator; None: torch's default)."""
        if views is None:
            views = self.make_views(x, generator)
        local_one, local_two, global_one, global_two = views
        proj_locals, _ = self.encoder(torch.cat([local_one, local_two]))
        proj_local_one, proj_local_two = proj_locals.chunk(2, dim=0)
        with torch.no_grad():
            proj_globals, _ = self.encoder(torch.cat([global_one, global_two]))
        proj_global_one, proj_global_two = proj_globals.chunk(2, dim=0)
        mse = (proj_local_one - proj_global_two).square().mean() + (proj_local_two - proj_global_one).square().mean()

        slices = None
        if sigreg_projs is None:
            seed = int(torch.randint(0, 2**62, (), generator=generator))
            slices = torch.Generator(device=proj_locals.device).manual_seed(seed)
        sreg = sigreg_loss(proj_locals, self.sigreg_num_slices, self.sigreg_domain, self.sigreg_num_knots,
                           projs=sigreg_projs, generator=slices)
        return mse * self.target_loss_weight + sreg * self.sigreg_loss_weight
