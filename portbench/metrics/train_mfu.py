"""The train step's share of the card's peak over the traced window: the
least time the model's work could take, over the wall time a step took
(the window over its steps; the steps run back to back, each ended by a
synchronize).

Model work a step of B sequences of T tokens: 6 * B * T flops a weight of
every layer's products and of the output head (forward and backward), at
the peak of a cuBLAS product of the run's dtype and TF32 setting; and the
causal attention, 3 x 4 * head_dim * heads flops a query-key pair a layer
a sequence, at the bf16 tensor-core peak its kernels run on.  The
recomputed forward is not model work."""
from portbench import bench


def read(ctx):
    tr, d = ctx["trace"], ctx["dims"]
    if tr is None or not ctx["steps"]:
        return None
    b, t = ctx["batch"], ctx["seq_len"]
    layer = (d.d_model * d.head_dim * (2 * d.n_heads + 2 * d.n_kv_heads)
             + 3 * d.d_model * d.d_ff)
    table = d.vocab_size * d.d_model
    mm = 6 * b * t * (d.n_layers * layer + table)
    attn = 3 * b * d.n_layers * 4 * d.head_dim * d.n_heads * t * (t + 1) // 2
    bound = (mm / bench.matmul_peak(ctx["dtype"], ctx["tf32"])
             + attn / bench.kernel_peak(ctx["dtype"]))
    return 100.0 * bound / (ctx["window_s"] / ctx["steps"])
