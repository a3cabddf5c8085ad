"""The whole prefill step's share of the card's peak over the traced
window: the least time the model's work could take, over the device time of
every kernel the prefills launched.

Model work of a prompt of T tokens: 2 * T flops a weight of every layer's
products (q, k, v, o, gate, up, down), 2 * d * V for the head at the last
position (the published vocabulary), at the peak of a cuBLAS product of the
run's dtype and TF32 setting; and the causal attention, 4 * head_dim *
heads flops a query-key pair a layer, at the bf16 tensor-core peak its
kernel runs on.  Where the weights' bytes take longer, they bound it."""
from portbench import bench


def pairs(t: int, window: int) -> int:
    if window <= 0 or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    d = run.dims
    if tr is None:
        return None
    elem = 2 if ctx["dtype"] in ("bfloat16", "float16") else 4
    layer = (d.d_model * d.head_dim * (2 * d.n_heads + 2 * d.n_kv_heads)
             + 3 * d.d_model * d.d_ff)
    table = d.vocab_size * d.d_model
    weight_s = elem * (d.n_layers * layer + table) / bench.HBM_BYTES_PER_S
    mm_peak = bench.matmul_peak(ctx["dtype"], ctx["tf32"])
    k_peak = bench.kernel_peak(ctx["dtype"])
    bound = secs = 0.0
    for name, ks in tr.kernels_in("serve.prefill:T="):
        t = int(name.split("=")[1])
        mm = 2 * t * d.n_layers * layer + 2 * table
        attn = d.n_layers * 4 * d.head_dim * d.n_heads * pairs(t, d.window)
        bound += max(mm / mm_peak + attn / k_peak, weight_s)
        secs += sum(e - s for _, s, e in ks) / 1e9
    if secs <= 0:
        return None
    return 100.0 * bound / secs
