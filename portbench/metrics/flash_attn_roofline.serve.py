"""The flash forward kernel's share of its roofline over the traced window's
prefills: the least time the card could take for the attention every
prefill needs, over the device time of ``flash_attention_kernel``.

Work a call (one layer of one prompt of T tokens): 4 * head_dim * heads *
pairs flops, pairs being the causal (and windowed) query-key pairs; bytes:
q and o [T, heads, head_dim], k and v [T, kv_heads, head_dim] read or
written once.  Its products run on the bf16 tensor cores whatever the input
dtype (f32 as split bf16 passes), so the bf16 peak bounds it."""
from portbench import bench


def pairs(t: int, window: int) -> int:
    if window <= 0 or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def read(ctx):
    tr, d = ctx["trace"], ctx["run"].dims
    if tr is None:
        return None
    secs, n = tr.kernel_seconds("flash_attention_kernel")
    if n == 0 or secs <= 0:
        return None
    elem = 2 if ctx["dtype"] in ("bfloat16", "float16") else 4
    bound = 0.0
    for name, _, _ in tr.spans:
        if name.startswith("serve.prefill:T="):
            t = int(name.split("=")[1])
            flops = 4 * d.head_dim * d.n_heads * pairs(t, d.window)
            nbytes = elem * t * d.head_dim * 2 * (d.n_heads + d.n_kv_heads)
            bound += d.n_layers * max(flops / bench.kernel_peak(ctx["dtype"]),
                                      nbytes / bench.HBM_BYTES_PER_S)
    return 100.0 * bound / secs
