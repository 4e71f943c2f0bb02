"""DeiT-style knowledge distillation (reference distill.py:22-159), port of
``vit_pytorch_tpu/ssl/distill.py``.

``DistillableViT``, ``DistillableT2TViT`` and ``DistillableEfficientViT``
are the port's ``ViT``, ``T2TViT`` and efficient ``ViT`` whose forward takes
an optional distillation token ((1, dim)), appended after the sequence (and
before the embedding dropout, which then drops it too: reference
distill.py:33-34, 64-66), left out of the position table and the pooling,
and returned beside the logits; each one's ``to_vit()`` is the plain model
with the same state_dict.  ``DistillWrapper`` holds the teacher and the
student (reference layout: ``teacher.*``, ``student.*``,
``distillation_token``, ``distill_mlp.0|1``); its loss is the student's
cross-entropy and, weighted by ``alpha``, the KL divergence of the
distillation head's tempered softmax from the teacher's times T**2 (or,
``hard``, the cross-entropy against the teacher's argmax), in float32 as
the port's train step computes its loss.  The teacher runs frozen: in eval
mode, under ``no_grad`` (:func:`distill_forward`, the JAX
``distill_forward``), unless the caller hands its logits over.

On the card in bf16 the student's and the teacher's transformers run the
port's kernels: the teacher's the whole-layer kernels, the student's the
whole layers in serving and the attention-block kernels in training with
dropout.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.efficient import ViT as EfficientViT
from ..models.t2t import T2TViT
from ..models.vit import ViT
from ..nn.blocks import LayerNorm
from ..utils.helpers import default


def _append(x, distill_token):
    """x with the (1, dim) token appended to each sequence."""
    return torch.cat([x, distill_token.to(x.dtype).reshape(1, 1, -1).expand(x.shape[0], -1, -1)], dim=1)


def _split(x, distilling: bool):
    return (x[:, :-1], x[:, -1]) if distilling else (x, None)


class _Distillable:
    """The constructor's keywords, kept for ``to_vit``."""

    plain: type

    def _keep_kwargs(self, kwargs):
        self._init_kwargs = {k: v for k, v in kwargs.items() if k != "generator"}

    def to_vit(self):
        """The plain model of the same keywords with this one's state_dict
        (reference distill.py:59-62), on its device and in its dtype."""
        p = next(self.parameters())
        kwargs = {**self._init_kwargs, "device": p.device}
        if "transformer" in kwargs and kwargs["transformer"] is not None:
            kwargs["transformer"] = copy.deepcopy(kwargs["transformer"])
        v = self.plain(**kwargs).to(p.dtype)
        v.load_state_dict(self.state_dict())
        return v

    def _out(self, x, distilling):
        x, distill_out = _split(x, distilling)
        out = self.head(x)
        return (out, distill_out) if distilling else out


class DistillableViT(_Distillable, ViT):
    """reference distill.py:51-67 — the port ``ViT``'s keywords."""

    plain = ViT

    def __init__(self, **kwargs):
        ViT.__init__(self, **kwargs)
        self._keep_kwargs(kwargs)

    def head(self, x):
        return self.mlp_head(x.mean(dim=1) if self.pool == "mean" else x[:, 0])

    def forward(self, img, distill_token=None):
        distilling = distill_token is not None
        x = self.embed(img, dropout=False)
        if distilling:
            x = _append(x, distill_token)
        return self._out(self.transformer(self.dropout(x)), distilling)


class DistillableT2TViT(_Distillable, T2TViT):
    """reference distill.py:69-85 — the port ``T2TViT``'s keywords."""

    plain = T2TViT

    def __init__(self, **kwargs):
        T2TViT.__init__(self, **kwargs)
        self._keep_kwargs(kwargs)

    def forward(self, img, distill_token=None):
        distilling = distill_token is not None
        x = self.embed(img, dropout=False)
        if distilling:
            x = _append(x, distill_token)
        return self._out(self.trunk(self.dropout(x)), distilling)


class DistillableEfficientViT(_Distillable, EfficientViT):
    """reference distill.py:87-101 — the efficient shell's keywords; no
    embedding dropout (reference :100-101)."""

    plain = EfficientViT

    def __init__(self, **kwargs):
        EfficientViT.__init__(self, **kwargs)
        self._keep_kwargs(kwargs)

    def forward(self, img, distill_token=None):
        distilling = distill_token is not None
        x = self.embed(img)
        if distilling:
            x = _append(x, distill_token)
        return self._out(self.transformer(x), distilling)


def distillation_loss(student_logits, distill_logits, teacher_logits, labels, temperature: float, alpha: float,
                      hard: bool = False) -> torch.Tensor:
    """(1 - alpha) * CE(student, labels) + alpha * the distillation term
    (reference distill.py:135-159), in float32: the KL divergence
    ``sum q (log q - log p) / batch`` of the tempered softmaxes times T**2,
    q clipped at 1e-20 inside the log, or with ``hard`` the cross-entropy
    against the teacher's argmax."""
    loss = F.cross_entropy(student_logits.float(), labels)
    if hard:
        distill_loss = F.cross_entropy(distill_logits.float(), teacher_logits.argmax(dim=-1))
    else:
        log_p = F.log_softmax(distill_logits.float() / temperature, dim=-1)
        q = F.softmax(teacher_logits.float() / temperature, dim=-1)
        distill_loss = (q * (q.clamp_min(1e-20).log() - log_p)).sum() / student_logits.shape[0]
        distill_loss = distill_loss * temperature**2
    return loss * (1 - alpha) + distill_loss * alpha


class DistillWrapper(nn.Module):
    """reference distill.py:105 — same keyword constructor (``teacher``,
    ``student``, ``temperature``, ``alpha``, ``hard``, ``mlp_layernorm``),
    with ``generator`` drawing the distillation token (unit normal) and
    initialising the head as the JAX package does.  ``forward(img, labels,
    temperature=None, alpha=None, *, teacher_logits=None)`` returns the
    loss; without ``teacher_logits`` the teacher runs frozen
    (:meth:`teacher_logits`)."""

    def __init__(self, *, teacher: nn.Module, student: nn.Module, temperature: float = 1.0, alpha: float = 0.5,
                 hard: bool = False, mlp_layernorm: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        p = next(student.parameters())
        kw = {"device": p.device, "dtype": p.dtype}
        dim, num_classes = student.dim, student.num_classes
        self.teacher, self.student = teacher, student
        self.temperature, self.alpha, self.hard = temperature, alpha, hard
        self.distillation_token = nn.Parameter(torch.empty(1, dim, **kw))
        self.distill_mlp = nn.Sequential(LayerNorm(dim, **kw) if mlp_layernorm else nn.Identity(),
                                         nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        from ..models.vit import init_modules_like_jax

        init_modules_like_jax(self.distill_mlp, generator)
        self.distillation_token.normal_(generator=generator)

    @torch.no_grad()
    def teacher_logits(self, img):
        """The teacher's logits, in eval mode and without gradients (its
        training mode restored after)."""
        was_training = self.teacher.training
        self.teacher.eval()
        try:
            return self.teacher(img)
        finally:
            self.teacher.train(was_training)

    def forward(self, img, labels, temperature: Optional[float] = None, alpha: Optional[float] = None, *,
                teacher_logits=None):
        if teacher_logits is None:
            teacher_logits = self.teacher_logits(img)
        student_logits, distill_tokens = self.student(img, distill_token=self.distillation_token)
        return distillation_loss(student_logits, self.distill_mlp(distill_tokens), teacher_logits.detach(), labels,
                                 default(temperature, self.temperature), default(alpha, self.alpha), self.hard)


def distill_forward(wrapper: DistillWrapper, img, labels, *, temperature: Optional[float] = None,
                    alpha: Optional[float] = None):
    """One distillation loss (reference distill.py:135-159, the JAX
    ``distill_forward``): the teacher frozen, then the wrapper."""
    return wrapper(img, labels, temperature, alpha, teacher_logits=wrapper.teacher_logits(img))
