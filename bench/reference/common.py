"""A decoder transformer in plain fp32 PyTorch: dense (SwiGLU) or routed
experts, GQA attention with RMS-normed queries and keys where the
configuration says so, RoPE, tied or untied head; the forward over a
sequence, a forward step by step over a cache, the training loss and
gradients, and AdamW.

It follows the configuration's file (``spec``), and the port's documented
semantics where the configuration departs from the published model (the
MoE's capacity-limited grouped dispatch).  Each departure is listed in the
configuration's file.  Weights come in the port's layout: [in, out]
products, norm scales applied as ``1 + scale``.

``quant="fp8"`` rounds both operands of every product of the layers and
the head to float8 e4m3 with a per-tensor scale (accumulation stays fp32):
the control that a lower precision has to fail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def strict_fp32() -> None:
    """No TF32 anywhere: fp32 products are fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in fp32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd] rotated by positions [S]: the halves of each head as
    (real, imaginary) parts, frequencies theta^(-i / (hd/2))."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = (positions.double()[:, None] * freqs).float()
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


class Reference:
    """The model of ``spec`` over ``params`` (any dtype; held here in fp32)."""

    def __init__(self, spec: dict, params: dict, quant: str | None = None,
                 requires_grad: bool = False):
        strict_fp32()
        self.spec = spec
        self.quant = quant
        f32 = lambda t: t.detach().to(torch.float32).clone().requires_grad_(requires_grad)
        self.p = {k: f32(t) for k, t in params.items() if k != "layers"}
        self.layers = [{k: f32(t) for k, t in layer.items()} for layer in params["layers"]]

    # ------------------------------------------------------------ products

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        """t as the products take it: in fp8 under the control (its
        backward passes the gradient through unchanged)."""
        return t + (fp8(t.detach()) - t).detach() if self.quant == "fp8" else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._q(x) @ self._q(w)

    def head_weight(self) -> torch.Tensor:
        return self.p["embedding"].T if self.spec["tie_embeddings"] else self.p["lm_head"]

    # --------------------------------------------------------------- blocks

    def attention(self, p: dict, x: torch.Tensor, start: int, cache: list | None,
                  i: int) -> torch.Tensor:
        """x [B, S, d] at positions start..start+S-1; ``cache`` (a list of
        [k, v] a layer, [B, Hkv, T, hd] so far) grows by S positions."""
        s = self.spec
        b, n, _ = x.shape
        h, hkv, hd = s["n_heads"], s["n_kv_heads"], s["head_dim"]
        q = self.mm(x, p["wq"]).view(b, n, h, hd)
        k = self.mm(x, p["wk"]).view(b, n, hkv, hd)
        v = self.mm(x, p["wv"]).view(b, n, hkv, hd)
        if s["qk_norm"]:
            q = rms_norm(q, p["q_norm"], s["rms_eps"])
            k = rms_norm(k, p["k_norm"], s["rms_eps"])
        pos = torch.arange(start, start + n, device=x.device)
        q, k = rope(q, pos, s["rope_theta"]), rope(k, pos, s["rope_theta"])
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # [B, H, n, hd]
        if cache is not None:
            if len(cache) <= i:
                cache.append([k, v])
            else:
                cache[i] = [torch.cat([cache[i][0], k], 2), torch.cat([cache[i][1], v], 2)]
            k, v = cache[i]
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        scores = (q @ k.transpose(-1, -2)) * hd ** -0.5           # [B, H, n, T]
        t = k.shape[2]
        allowed = (torch.arange(t, device=x.device)[None, :]
                   <= (start + torch.arange(n, device=x.device))[:, None])
        scores = scores.masked_fill(~allowed, float("-inf"))
        out = torch.softmax(scores, dim=-1) @ v                   # [B, H, n, hd]
        return self.mm(out.transpose(1, 2).reshape(b, n, h * hd), p["wo"])

    def mlp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return self.mm(F.silu(self.mm(x, p["w_gate"])) * self.mm(x, p["w_up"]), p["w_down"])

    def moe(self, p: dict, x: torch.Tensor, token_chunk: int = 4096) -> torch.Tensor:
        """Top-k routing over softmax probabilities (renormalised over the k),
        dispatched within groups: the call's B*S tokens in order, split into
        the largest count of equal groups not above ``dispatch_groups``; in
        each group an expert takes the tokens that chose it in token order,
        up to ``int(tokens * k / E * capacity_factor) + 1`` of them, and a
        token over that keeps only its residual.  Every expert is computed
        on every token and the kept ones are weighted in."""
        moe = self.spec["moe"]
        e, k = moe["n_experts"], moe["top_k"]
        b, n, d = x.shape
        t = b * n
        g = min(moe["dispatch_groups"], t)
        while t % g:
            g -= 1
        tg = t // g
        cap = max(int(tg * k / e * moe["capacity_factor"]) + 1, 1)
        xf = x.reshape(t, d)
        probs = torch.softmax(self.mm(xf, p["router"]), dim=-1)
        top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_w, top_i = top_w[:, :k], top_i[:, :k]
        top_w = top_w / top_w.sum(-1, keepdim=True)
        chosen = torch.zeros(t, e, device=x.device).scatter_(1, top_i, 1.0)
        weight = torch.zeros(t, e, device=x.device).scatter_(1, top_i, top_w)
        rank = torch.cumsum(chosen.view(g, tg, e), dim=1).view(t, e) - 1
        coef = weight * (chosen > 0) * (rank < cap)
        wg, wu, wd = (self._q(p[n_]) for n_ in ("experts_w_gate", "experts_w_up",
                                               "experts_w_down"))
        outs = []
        for c0 in range(0, t, token_chunk):
            xc = self._q(xf[c0:c0 + token_chunk])
            hid = F.silu(torch.einsum("cd,edf->ecf", xc, wg)) * torch.einsum(
                "cd,edf->ecf", xc, wu)
            y = torch.einsum("ecf,efd->ecd", self._q(hid), wd)
            outs.append(torch.einsum("ce,ecd->cd", coef[c0:c0 + token_chunk], y))
        return torch.cat(outs).view(b, n, d)

    def block(self, i: int, x: torch.Tensor, start: int, cache: list | None) -> torch.Tensor:
        p, s = self.layers[i], self.spec
        x = x + self.attention(p, rms_norm(x, p["norm1"], s["rms_eps"]), start, cache, i)
        h = rms_norm(x, p["norm2"], s["rms_eps"])
        return x + (self.moe(p, h) if s.get("moe") else self.mlp(p, h))

    # -------------------------------------------------------------- passes

    def hidden(self, tokens: torch.Tensor, start: int = 0,
               cache: list | None = None) -> torch.Tensor:
        """The final-normed hidden states [B, S, d] of tokens [B, S] at
        positions start.., over ``cache`` when given (which they extend)."""
        x = self.p["embedding"][tokens.long()]
        for i in range(self.spec["n_layers"]):
            x = self.block(i, x, start, cache)
        return rms_norm(x, self.p["final_norm"], self.spec["rms_eps"])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.mm(h, self.head_weight())

    def nll_sum(self, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Sum over positions of -log p(label)."""
        logits = self.logits(self.hidden(tokens))
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, labels.long()[..., None])[..., 0]).sum()


def served_logits(ref: Reference, prompts: torch.Tensor, served: torch.Tensor,
                  step_by_step: bool) -> torch.Tensor:
    """The logits [B, n, V] that predict each of the ``n`` served tokens
    [B, n] after prompts [B, S]: teacher-forced, position S-1+j predicting
    served[:, j].  ``step_by_step`` runs the prompt and then one position a
    call over a cache, as a server does (the MoE's groups are then the
    server's: the batch's prompts, then its rows of each step); otherwise
    one forward over each whole sequence."""
    with torch.no_grad():
        s, n = prompts.shape[1], served.shape[1]
        if not step_by_step:
            seq = torch.cat([prompts, served[:, :-1]], dim=1)
            return ref.logits(ref.hidden(seq)[:, s - 1:])
        cache: list = []
        out = [ref.logits(ref.hidden(prompts, 0, cache)[:, -1:])]
        for j in range(n - 1):
            out.append(ref.logits(ref.hidden(served[:, j:j + 1], s + j, cache)))
        return torch.cat(out, dim=1)


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best logit of its row."""
    return logits.amax(-1) - logits.gather(-1, tokens.long()[..., None])[..., 0]


# --------------------------------------------------------------- training


def lr_at(step: int, peak: float, warmup: int, total: int, min_ratio: float = 0.1) -> float:
    """Linear warm-up from 0 at step 0 to ``peak`` at ``warmup``, then a
    cosine decay to ``min_ratio * peak`` at ``total``."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))


def train_steps(spec: dict, params: dict, batches: list[dict], opt: dict,
                storage=torch.bfloat16, quant: str | None = None) -> dict:
    """``len(batches)`` AdamW steps from ``params``: each batch's mean
    cross-entropy over its tokens, its gradient summed one row at a time,
    clipped by the global norm, and the update computed in fp32 and stored
    in the configuration's type (``storage``), as the configuration keeps
    its parameters.  Returns the loss of each step and, by leaf, the norm
    of the first step's gradient as the optimizer takes it (after
    clipping) and the norm of the parameters' change over the steps; and
    that first gradient itself by leaf, on the host."""
    ref = Reference(spec, params, quant=quant, requires_grad=True)
    names = list(ref.p) + [f"layers.{i}.{n}" for i, layer in enumerate(ref.layers)
                           for n in layer]
    if spec.get("moe"):
        raise NotImplementedError("the training reference has no MoE auxiliary loss")
    tensors = list(ref.p.values()) + [t for layer in ref.layers for t in layer.values()]
    for t in tensors:
        t.data = t.data.to(storage).to(torch.float32)
    m = [torch.zeros_like(t) for t in tensors]
    v = [torch.zeros_like(t) for t in tensors]
    losses, first_grad, first_vec = [], None, None
    for k, batch in enumerate(batches):
        tokens, labels = batch["tokens"], batch["labels"]
        count = tokens.numel()
        grads = [torch.zeros_like(t) for t in tensors]
        total = 0.0
        for r in range(tokens.shape[0]):
            loss_r = ref.nll_sum(tokens[r:r + 1], labels[r:r + 1]) / count
            for acc, g in zip(grads, torch.autograd.grad(loss_r, tensors)):
                acc += g
            total += loss_r.item()
        losses.append(total)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(opt["grad_clip"] / torch.clamp(gnorm, min=1e-12), max=1.0)
            lr = lr_at(k, opt["lr"], opt["warmup_steps"], opt["total_steps"])
            b1, b2, t = opt["b1"], opt["b2"], k + 1
            for p_, m_, v_, g in zip(tensors, m, v, grads):
                g = g * scale
                m_.mul_(b1).add_((1 - b1) * g)
                v_.mul_(b2).add_((1 - b2) * g * g)
                upd = (m_ / (1 - b1 ** t)) / (torch.sqrt(v_ / (1 - b2 ** t)) + 1e-8)
                p_.data = (p_.data * (1 - lr * opt["weight_decay"]) - lr * upd).to(
                    storage).to(torch.float32)
            if first_grad is None:
                first_grad = {n: torch.linalg.vector_norm(g * scale).item()
                              for n, g in zip(names, grads)}
                first_vec = {n: (g * scale).cpu() for n, g in zip(names, grads)}
        del grads
    start = flat_leaves(params)
    with torch.no_grad():
        change = {n: torch.linalg.vector_norm(t - start[n].float()).item()
                  for n, t in zip(names, tensors)}
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "first_vec": first_vec}


def flat_leaves(params: dict) -> dict[str, torch.Tensor]:
    """The parameters by the port's names ("embedding", "layers.3.wq", ...)."""
    out = {k: t for k, t in params.items() if k != "layers"}
    for i, layer in enumerate(params["layers"]):
        out.update({f"layers.{i}.{n}": t for n, t in layer.items()})
    return out
