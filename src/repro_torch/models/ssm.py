"""Sequence-state blocks — the port of `repro.models.ssm`: Mamba2 (SSD)
for the hybrid family (zamba2), and xLSTM's mLSTM / sLSTM blocks for
the ssm family (xlstm).

The reference writes these cores in jnp, not Pallas, so they stay plain
PyTorch here; only their norms run a kernel (`layers.rmsnorm`, the
RMSNorm kernel on CUDA). The numbers follow the reference's cast points:
the cores compute in f32 and cast their output back to the input's
dtype; the gate pre-activations and the sLSTM state are f32; masks go
in log space (-1e30) before `exp`, so neither the value nor the
gradient of the masked upper triangle overflows. The chunked cores keep
the reference's `S % chunk == 0` assert (`chunk = min(128, S)`): no
padding, so a prompt is at most 128 tokens or a multiple of 128.

The reference's `lax.scan`s become Python loops: over S / chunk chunks
for the Mamba2 and mLSTM inter-chunk states, and over every token for
the sLSTM (about 20 small ops a step, host-bound on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import act_sharding, layers
from repro_torch.models.act_sharding import pin_grad, replaceable

MAMBA_HEAD_DIM = 64
NEG = -1e30   # the reference's log-space mask value


@replaceable
def log_sigmoid(x):
    """`F.logsigmoid(x)`."""
    return F.logsigmoid(x)


def _tril(n, device):
    return torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def mamba_dims(cfg: ModelConfig):
    """(d_in, heads H, head dim P, state N, groups G)."""
    d_in = cfg.ssm.expand * cfg.d_model
    H = d_in // MAMBA_HEAD_DIM
    return d_in, H, MAMBA_HEAD_DIM, cfg.ssm.state_dim, cfg.ssm.n_groups


def init_mamba(cfg: ModelConfig, gen, dtype, device):
    """The reference's init scales; `A_log`, `D` and `dt_bias` are f32
    whatever `dtype` is."""
    d = cfg.d_model
    d_in, H, P, N, G = mamba_dims(cfg)
    conv_ch = d_in + 2 * G * N
    f32 = torch.float32
    return {
        # fused in_proj -> [z (d_in), xBC (d_in + 2GN), dt (H)]
        "w_in": layers.dense_init(gen, d, 2 * d_in + 2 * G * N + H, dtype,
                                  device),
        "conv_w": (torch.randn(cfg.ssm.conv_dim, conv_ch, generator=gen,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=device)),
        "D": torch.ones(H, dtype=f32, device=device),
        "dt_bias": torch.zeros(H, dtype=f32, device=device),
        "norm_w": torch.ones(d_in, dtype=dtype, device=device),
        "w_out": layers.dense_init(gen, d_in, d, dtype, device),
    }


@replaceable
def in_proj(x, w, sizes):
    """`x @ w` split along its last dim into pieces of `sizes` (views of
    the one product). The dry run's form runs one product per piece, so
    each comes out sharded on its own channels."""
    return torch.split(x @ w, sizes, dim=-1)


def _in_proj(cfg, p, x):
    """Mamba2's fused in-projection as its pieces z, x, B, C, dt."""
    d_in, H, P, N, G = mamba_dims(cfg)
    return in_proj(x, p["w_in"], (d_in, d_in, G * N, G * N, H))


def _conv_pieces(p, pieces, conv_cache, conv):
    """The depthwise conv `conv(t, w, b, cache) -> (out, new_cache)` run
    on each of x, B and C (`pieces`) with its own channels of conv_w,
    conv_b and conv_cache (B, K-1, C) or None: per channel, so the values
    of one conv over their concatenation. Returns (x, B, C, new
    conv_cache)."""
    sizes = [t.shape[-1] for t in pieces]
    ws = torch.split(p["conv_w"], sizes, dim=-1)
    bs = torch.split(p["conv_b"], sizes, dim=-1)
    caches = (None,) * len(sizes) if conv_cache is None \
        else torch.split(conv_cache, sizes, dim=-1)
    outs, news = zip(*(conv(*a) for a in zip(pieces, ws, bs, caches)))
    return (*outs, torch.cat(news, dim=-1))


def _causal_conv(xBC, w, b, conv_cache=None):
    """Depthwise causal conv. xBC: (B, S, C); w: (K, C); conv_cache:
    (B, K-1, C) trailing inputs of the previous call, or None. The K
    shifted products are summed in order, as the reference sums them.
    Returns (silu(out), new_cache)."""
    B, S, C = xBC.shape
    K = w.shape[0]
    if conv_cache is None:      # laid out as xBC is
        conv_cache = torch.zeros_like(xBC[:, :1]).expand(B, K - 1, C)
    xp = torch.cat([conv_cache, xBC], dim=1)            # (B, S+K-1, C)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    new_cache = xp[:, S:] if K > 1 else xp[:, :0]
    return F.silu(out + b), new_cache


@replaceable
def ssd_chunked(x, dt, A, Bm, Cm, *, chunk=128, initial_state=None):
    """Chunked SSD. x: (B, S, H, P); dt: (B, S, H); A: (H,) negative;
    Bm, Cm: (B, S, G, N) with G dividing H. Returns (y in x.dtype,
    final_state (B, H, N, P) f32). Every head is independent of the
    others (the dry run's form runs each rank's own heads)."""
    B, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    chunk = min(chunk, S)
    assert S % chunk == 0
    nc = S // chunk

    Bh = Bm.repeat_interleave(rep, dim=2)               # (B, S, H, N)
    Ch = Cm.repeat_interleave(rep, dim=2)
    xr = x.reshape(B, nc, chunk, H, Pd).float()
    dtr = dt.reshape(B, nc, chunk, H).float()
    Br = Bh.reshape(B, nc, chunk, H, N).float()
    Cr = Ch.reshape(B, nc, chunk, H, N).float()

    dA = dtr * A                                        # (B, nc, Q, H)
    cum = torch.cumsum(dA, dim=2)   # within-chunk inclusive cumsum

    # intra-chunk: decay L[i, j] = exp(cum_i - cum_j) for i >= j, masked
    # in log space
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    mask = _tril(chunk, x.device)[None, None, :, :, None]
    Lmat = torch.exp(torch.where(mask, diff, NEG))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cr, Br) * Lmat \
        * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xr)

    # chunk-local end states
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B, nc, Q, H)
    states = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", dec_end * dtr, Br, xr)
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B, nc, H)

    # inter-chunk state propagation (the reference's scan)
    s = (torch.zeros((B, H, N, Pd), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    entries = []
    for c in range(nc):
        entries.append(s)           # the state entering chunk c
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    entry_states = torch.stack(entries, dim=1)          # (B, nc, H, N, P)

    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           Cr * torch.exp(cum)[..., None], entry_states)
    y = (y_intra + y_inter).reshape(B, S, H, Pd)
    return y.to(x.dtype), s


def mamba_forward(cfg: ModelConfig, p, x, *, state=None, conv_cache=None,
                  chunk=128):
    """Full-sequence Mamba2 block. x: (B, S, d). Returns
    (out, (final_state, conv_cache))."""
    d_in, H, P, N, G = mamba_dims(cfg)
    z, xs, Bm, Cm, dt = _in_proj(cfg, p, x)
    xs, Bm, Cm, new_conv = _conv_pieces(p, (xs, Bm, Cm), conv_cache,
                                        _causal_conv)
    B_, S = x.shape[0], x.shape[1]
    xs = xs.reshape(B_, S, H, P)
    Bm = Bm.reshape(B_, S, G, N)
    Cm = Cm.reshape(B_, S, G, N)
    dtp = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, fstate = ssd_chunked(xs, dtp, A, Bm, Cm, chunk=chunk,
                            initial_state=state)
    y = y + (p["D"][:, None] * xs.float()).to(y.dtype)
    y = pin_grad(y.reshape(B_, S, d_in))   # as in mLSTM
    y = layers.rmsnorm(y * F.silu(z), p["norm_w"])
    return y @ p["w_out"], (fstate, new_conv)


@replaceable
def ssd_step(state, dec, dt, x, Bm, Cm):
    """One token of the SSD recurrence. state: (B, H, N, P) f32; dec, dt:
    (B, H) f32; x: (B, H, P) f32; Bm, Cm: (B, G, N) with G dividing H.
    The state decays by dec and takes dt * B x; y (B, H, P) reads the new
    state through C. Returns (state, y). Every (b, h) is independent of
    the others (the dry run's form runs each rank's own block)."""
    rep = state.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).float()       # (B, H, N)
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    state = state * dec[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhnp", dt, Bh, x)
    return state, torch.einsum("bhn,bhnp->bhp", Ch, state)


def mamba_decode(cfg: ModelConfig, p, x, state, conv_cache):
    """Single-token recurrent step. x: (B, 1, d); state: (B, H, N, P) f32;
    conv_cache: (B, K-1, C). Returns (out, (state, conv_cache))."""
    d_in, H, P, N, G = mamba_dims(cfg)
    z, xs, Bm, Cm, dt = _in_proj(cfg, p, x)

    def conv_step(t, w, b, cache):
        xp = torch.cat([cache, t], dim=1)               # (B, K, c)
        return F.silu((xp * w[None]).sum(dim=1) + b), xp[:, 1:]
    xs, Bm, Cm, new_conv = _conv_pieces(p, (xs, Bm, Cm), conv_cache,
                                        conv_step)
    B_ = x.shape[0]
    xs = xs.reshape(B_, H, P)
    Bm = Bm.reshape(B_, G, N)
    Cm = Cm.reshape(B_, G, N)
    dtp = F.softplus(dt[:, 0].float() + p["dt_bias"])   # (B, H)
    A = -torch.exp(p["A_log"])
    dec = torch.exp(dtp * A)
    xs32 = xs.float()
    state, y = ssd_step(state, dec, dtp, xs32, Bm, Cm)
    y = y + p["D"][:, None] * xs32
    y = y.reshape(B_, 1, d_in).to(x.dtype)
    y = layers.rmsnorm(y * F.silu(z), p["norm_w"])
    return y @ p["w_out"], (state, new_conv)


# ===========================================================================
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory)
# ===========================================================================

def mlstm_dims(cfg: ModelConfig):
    """(d_in, heads H, head dim)."""
    d_in = cfg.ssm.expand * cfg.d_model
    H = cfg.n_heads
    return d_in, H, d_in // H


def init_mlstm(cfg: ModelConfig, gen, dtype, device):
    """The reference's init; the gate weights and biases are f32 (b_f = 3:
    a bias toward remembering)."""
    d = cfg.d_model
    d_in, H, hd = mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "w_up": layers.dense_init(gen, d, 2 * d_in, dtype, device),
        "wq": layers.dense_init(gen, d_in, d_in, dtype, device),
        "wk": layers.dense_init(gen, d_in, d_in, dtype, device),
        "wv": layers.dense_init(gen, d_in, d_in, dtype, device),
        "w_i": layers.dense_init(gen, d_in, H, f32, device),
        "w_f": layers.dense_init(gen, d_in, H, f32, device),
        "b_i": torch.zeros(H, dtype=f32, device=device),
        "b_f": torch.full((H,), 3.0, dtype=f32, device=device),
        "norm_w": torch.ones(d_in, dtype=dtype, device=device),
        "w_down": layers.dense_init(gen, d_in, d, dtype, device),
    }


def _mlstm_core_chunked(q, k, v, ig, fg, *, chunk=128, state=None):
    """Chunkwise stabilized mLSTM. q, k, v: (B, S, H, hd); ig, fg:
    (B, S, H) raw gate pre-activations. state: (C, n, m) with C
    (B, H, hd, hd), n (B, H, hd), m (B, H), or None (m starts at -inf).
    Returns (h in q.dtype, (C, n, m) f32)."""
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    nc = S // chunk
    scale = hd ** -0.5
    dev = q.device

    qf = (q.float() * scale).reshape(B, nc, chunk, H, hd)
    kf = k.float().reshape(B, nc, chunk, H, hd)
    vf = v.float().reshape(B, nc, chunk, H, hd)
    logf = log_sigmoid(fg.float()).reshape(B, nc, chunk, H)
    logi = ig.float().reshape(B, nc, chunk, H)
    cumf = torch.cumsum(logf, dim=2)   # inclusive within-chunk

    # intra decay D[i, j] = cumf_i - cumf_j + logi_j (i >= j), masked in
    # log space
    diff = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] \
        + logi[:, :, None, :, :]                        # (B,nc,Qi,Qj,H)
    diff = torch.where(_tril(chunk, dev)[None, None, :, :, None], diff, NEG)
    chunk_f = cumf[:, :, -1, :]      # (B, nc, H) total log-forget
    # chunk-local state (exponents relative to the chunk's end)
    s_end = chunk_f[:, :, None, :] - cumf + logi        # (B, nc, Q, H)
    m_loc = torch.amax(s_end, dim=2)                    # (B, nc, H)
    w_end = torch.exp(s_end - m_loc[:, :, None, :])
    C_loc = act_sharding.constrain_state(
        torch.einsum("bcjh,bcjhd,bcjhe->bchde", w_end, kf, vf))
    n_loc = torch.einsum("bcjh,bcjhd->bchd", w_end, kf)

    # inter-chunk scan over (C, n, m): elementwise only
    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, H), float("-inf"), dtype=torch.float32,
                       device=dev)
    else:
        C, n, m = state
    ent_C, ent_n, ent_m = [], [], []
    for c in range(nc):
        ent_C.append(C)
        ent_n.append(n)
        ent_m.append(m)
        cf, ml = chunk_f[:, c], m_loc[:, c]
        m_new = torch.maximum(cf + m, ml)
        w_old = torch.exp(cf + m - m_new)
        w_new = torch.exp(ml - m_new)
        C = C * w_old[..., None, None] + C_loc[:, c] * w_new[..., None, None]
        n = n * w_old[..., None] + n_loc[:, c] * w_new[..., None]
        m = m_new
    # (B, nc, H, hd, hd) chunk-entry states
    C_in = act_sharding.constrain_state(torch.stack(ent_C, dim=1))
    n_in = torch.stack(ent_n, dim=1)
    m_in = torch.stack(ent_m, dim=1)    # (B, nc, H)

    # combine intra + inter; query-side stabilizer
    # m_i = max(max_j diff[i, j], cumf_i + m_in)
    m_intra = torch.amax(diff, dim=3)                   # (B, nc, Qi, H)
    b_i = cumf + m_in[:, :, None, :]
    m_i = torch.maximum(m_intra, b_i)
    m_i = torch.clamp(m_i, min=NEG)  # guard -inf (empty context, zero state)
    w_intra = torch.exp(diff - m_i[:, :, :, None, :])   # (B,nc,Qi,Qj,H)
    scores = torch.einsum("bcihd,bcjhd->bcijh", qf, kf) * w_intra
    h_intra = torch.einsum("bcijh,bcjhe->bcihe", scores, vf)
    n_intra = torch.einsum("bcijh,bcjhd->bcihd", w_intra, kf)
    w_inter = torch.exp(b_i - m_i)                      # (B, nc, Qi, H)
    h_inter = torch.einsum("bcihd,bchde->bcihe", qf, C_in) \
        * w_inter[..., None]
    n_inter = n_in[:, :, None] * w_inter[..., None]     # (B,nc,Qi,H,hd)

    h_num = h_intra + h_inter
    n_tot = torch.einsum("bcihd,bcihd->bcih", qf, n_intra + n_inter)
    denom = torch.maximum(n_tot.abs(), torch.exp(-m_i))  # xLSTM normalizer
    h = (h_num / denom[..., None]).reshape(B, S, H, hd)
    return h.to(q.dtype), (C, n, m)


def mlstm_forward(cfg: ModelConfig, p, x, *, state=None, chunk=128):
    """x: (B, S, d) -> (out, (C, n, m))."""
    d_in, H, _ = mlstm_dims(cfg)
    B, S, _ = x.shape
    up = x @ p["w_up"]
    xi, z = up[..., :d_in], up[..., d_in:]
    q, k, v = (layers.split_heads(xi @ p[w], H) for w in ("wq", "wk", "wv"))
    ig = xi.float() @ p["w_i"] + p["b_i"]
    fg = xi.float() @ p["w_f"] + p["b_f"]
    h, new_state = _mlstm_core_chunked(q, k, v, ig, fg, chunk=chunk,
                                       state=state)
    # a DTensor gradient must arrive in the forward's layout to be viewed
    # back into heads
    h = pin_grad(h.reshape(B, S, d_in))
    h = layers.rmsnorm(h * F.silu(z), p["norm_w"])
    return h @ p["w_down"], new_state


def mlstm_decode(cfg: ModelConfig, p, x, state):
    """One-token recurrent mLSTM step (the exact recurrence). x:
    (B, 1, d); state (C, n, m) f32."""
    d_in, H, hd = mlstm_dims(cfg)
    B = x.shape[0]
    up = x @ p["w_up"]
    xi, z = up[..., :d_in], up[..., d_in:]
    q, k, v = (layers.split_heads(xi @ p[w], H).reshape(B, H, hd).float()
               for w in ("wq", "wk", "wv"))
    q = q * hd ** -0.5
    ig = (xi.float() @ p["w_i"] + p["b_i"])[:, 0]       # (B, H)
    fg = (xi.float() @ p["w_f"] + p["b_f"])[:, 0]
    C, n, m = state
    logf = log_sigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    w_old = torch.exp(logf + m - m_new)
    w_new = torch.exp(ig - m_new)
    C = C * w_old[..., None, None] + w_new[..., None, None] \
        * (k[..., :, None] * v[..., None, :])
    n = n * w_old[..., None] + w_new[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, d_in).to(x.dtype)
    h = layers.rmsnorm(h * F.silu(z), p["norm_w"])
    return h @ p["w_down"], (C, n, m_new)


def init_slstm(cfg: ModelConfig, gen, dtype, device):
    """Gates i, f, z, o; block-diagonal recurrent weights per head
    `r_gates` (4, H, hd, hd) and `b_gates` ([0, 3, 0, 0] blocks of d),
    both f32."""
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    f32 = torch.float32
    return {
        "w_gates": layers.dense_init(gen, d, 4 * d, dtype, device),
        "r_gates": torch.randn((4, H, hd, hd), generator=gen, dtype=f32,
                               device=device) * 0.02,
        "b_gates": torch.cat([torch.zeros(d, dtype=f32, device=device),
                              torch.full((d,), 3.0, dtype=f32,
                                         device=device),
                              torch.zeros(2 * d, dtype=f32, device=device)]),
        "norm_w": torch.ones(d, dtype=dtype, device=device),
        "w_out": layers.dense_init(gen, d, d, dtype, device),
    }


def slstm_forward(cfg: ModelConfig, p, x, *, state=None):
    """Sequential sLSTM over the sequence, one step per token. x:
    (B, S, d); state (c, n, m, h), each (B, H, hd) f32, or None (zeros,
    m = -10). Returns (out, state)."""
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    B, S, _ = x.shape
    pre = (x @ p["w_gates"]).float() + p["b_gates"]     # (B, S, 4d)
    pre = layers.split_heads(pre, 4).reshape(B, S, 4, H, hd)
    if state is None:
        z = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        state = (z, z, z - 10.0, z)
    hs, state = slstm_scan(pre, *state, recurrent_weights(p["r_gates"]))
    hs = pin_grad(hs.reshape(B, S, d).to(x.dtype))
    hs = layers.rmsnorm(hs, p["norm_w"])
    return hs @ p["w_out"], state


def recurrent_weights(r):
    """`r_gates` (4, H, hd, hd) laid out once for the token steps'
    product: (H, hd, 4 hd), each head's four gate blocks side by side, so
    every step's batched product reads it as it lies (an einsum over
    `r_gates` itself copies it into that layout at every token, and
    autograd keeps each copy)."""
    G, H, hd, _ = r.shape
    return r.permute(1, 2, 0, 3).reshape(H, hd, G * hd)


@replaceable
def slstm_scan(pre, c, n, m, h, r):
    """The sLSTM recurrence over pre (B, S, 4, H, hd) from the state (c,
    n, m, h), with the recurrent weights r laid out by
    `recurrent_weights` (H, hd, 4 hd): (every step's h stacked (B, S, H,
    hd), the last state)."""
    one = torch.ones((), dtype=torch.float32, device=pre.device)
    hs = []
    for t in range(pre.shape[1]):
        c, n, m, h = slstm_step(pre[:, t], c, n, m, h, r, one)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


def slstm_step(pre_t, c, n, m, h, r, one):
    """One token of the sLSTM recurrence: pre_t (B, 4, H, hd) and the
    state (c, n, m, h) to the next state, r laid out by
    `recurrent_weights`; `one` is a f32 scalar 1."""
    B, G, H, hd = pre_t.shape
    rh = torch.bmm(h.transpose(0, 1), r)                # (H, B, 4 hd)
    g = pre_t + rh.reshape(H, B, G, hd).permute(1, 2, 0, 3)
    ig, fg, zg, og = g.unbind(1)
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(logf + m - m_new)
    c = f_p * c + i_p * torch.tanh(zg)
    n = f_p * n + i_p
    # maximum, not clamp: at n == 1 (every first step) the gradient
    # splits between the two sides, as jnp.maximum's does
    h = torch.sigmoid(og) * c / torch.maximum(n, one)
    return c, n, m_new, h


def slstm_decode(cfg: ModelConfig, p, x, state):
    return slstm_forward(cfg, p, x, state=state)
