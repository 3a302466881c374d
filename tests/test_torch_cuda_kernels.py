"""K1-K9 on the card against their plain versions, at small shapes.

Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is False (a
CUDA kernel has no CPU mode). On a machine with an H100:
``python -m pytest -m gpu tests/test_torch_cuda_kernels.py``. The full-width
parity and timing run is ``python3 chip_smoke.py``.
"""

import pytest
import torch

from interspeech_ser_tpu_torch.ops.kernels import attention as k_attn
from interspeech_ser_tpu_torch.ops.kernels import attention_bhtd as k_bhtd
from interspeech_ser_tpu_torch.ops.kernels import conv_frontend as k_conv
from interspeech_ser_tpu_torch.ops.kernels import ffn_fused as k_ffn
from interspeech_ser_tpu_torch.ops.kernels import gru as k_gru
from interspeech_ser_tpu_torch.ops.kernels import pos_conv as k_pos

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _key_mask(T, masked):
    """Row 2 leaves the last two 64-key tiles fully masked; with ``"dead"``
    row 1 has no live key at all (sum(V) / Tk_p, Tk_p = 256 at T = 150)."""
    lengths = [150, 0 if masked == "dead" else 77, 40]
    return (torch.arange(T, device="cuda")[None] < torch.tensor(lengths, device="cuda")[:, None]).float()


def _assert_dead_row(a, b, dtype, what, row=1):
    """The batch row with no live key, alone: f32 max-abs <= 1e-5; bf16
    max-abs <= 1e-2 x max|ref| of the row, which a wrong scale (Tk for Tk_p)
    breaks and cosine does not see."""
    err = float((a[row].float() - b[row].float()).abs().max())
    bar = 1e-5 if dtype == torch.float32 else 1e-2 * float(b[row].abs().max())
    assert err <= bar, (what, err, bar)


def _assert_bwd_close(got, ref, dtype, masked):
    for name, a, b in zip(("dq", "dk", "dv", "dgate", "dbias"), got, ref):
        assert (a is None) == (b is None)
        if b is None:
            continue
        if dtype == torch.float32:
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        else:
            assert torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(), dim=0) >= 0.999
        if masked == "dead" and name != "dbias":
            _assert_dead_row(a, b, dtype, name)


MASKS = [(True, True), (True, False), (False, True), (False, False), (True, "dead"), (False, "dead")]


@pytest.mark.parametrize("bias,masked", MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel(cuda, bias, masked, dtype):
    B, T, H = 3, 150, 4
    q, k, v = (torch.randn(B, T, 64 * H, generator=cuda, device="cuda").to(dtype) for _ in range(3))
    kw = {}
    if masked:
        kw["key_mask"] = _key_mask(T, masked)
    if bias:
        kw["gate"] = 1 + torch.rand(B, H, T, generator=cuda, device="cuda")
        kw["pos_bias"] = torch.randn(H, T, T, generator=cuda, device="cuda")
    before = k_attn.LAUNCHES
    out = k_attn.attention_btd(q, k, v, H, **kw)
    torch.cuda.synchronize()
    assert k_attn.LAUNCHES == before + 1
    ref = k_attn.attention_btd_plain(q, k, v, H, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        assert torch.nn.functional.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0) >= 0.999
    if masked == "dead":
        _assert_dead_row(out, ref, dtype, "out")


def _attention_bwd_inputs(gen, bias, masked, dtype, B=3, T=150, H=4, hd=64):
    q, k, v, g = (torch.randn(B, T, hd * H, generator=gen, device="cuda").to(dtype) for _ in range(4))
    kw = {}
    if masked:
        kw["key_mask"] = _key_mask(T, masked)
    if bias:
        kw["gate"] = 1 + torch.rand(B, H, T, generator=gen, device="cuda")
        kw["pos_bias"] = torch.randn(H, T, T, generator=gen, device="cuda")
    return (q, k, v, g, H), kw


@pytest.mark.parametrize("bias,masked", MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel(cuda, bias, masked, dtype):
    """K4 (on K1's output and lse) against the plain backward; a rerun is bit-identical."""
    (q, k, v, g, H), kw = _attention_bwd_inputs(cuda, bias, masked, dtype)
    out, lse = k_attn.attention_btd_fwd(q, k, v, H, **kw)
    before = k_attn.BWD_LAUNCHES
    got = k_attn.attention_btd_bwd(q, k, v, g, H, **kw, out=out, lse=lse)
    torch.cuda.synchronize()
    assert k_attn.BWD_LAUNCHES == before + 1
    ref = k_attn.attention_btd_bwd_plain(q, k, v, g, H, **kw)
    _assert_bwd_close(got, ref, dtype, masked)
    again = k_attn.attention_btd_bwd(q, k, v, g, H, **kw, out=out, lse=lse)
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, again))


def test_attention_function_grads_match_plain_autograd(cuda):
    """AttentionBtdTrain (K1 + K4) against autograd through the plain forward, every input
    requiring grad; with the bias frozen its cotangent is None and K4 skips it."""
    (q, k, v, g, H), kw = _attention_bwd_inputs(cuda, True, True, torch.float32)
    grads = []
    for fn in (k_attn.AttentionBtdTrain.apply, k_attn.attention_btd_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, kw["gate"], kw["pos_bias"])]
        out = fn(*leaves[:3], H, kw["key_mask"], None, leaves[3], leaves[4])
        grads.append(torch.autograd.grad(out, leaves, g))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, kw["gate"])]
    out = k_attn.AttentionBtdTrain.apply(*leaves[:3], H, kw["key_mask"], None, leaves[3], kw["pos_bias"])
    dgate = torch.autograd.grad(out, leaves[3], g)[0]
    torch.testing.assert_close(dgate, grads[1][3], atol=1e-5, rtol=1e-4)


def test_attention_launcher_refuses_grad(cuda):
    q = torch.randn(2, 10, 64, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="AttentionBtdTrain"):
        k_attn.attention_btd(q, q.detach(), q.detach(), 1)


def test_lora_factors_get_gradients_on_the_card(cuda):
    """A 2-layer Whisper encoder on the card: every LoRA factor gets a non-zero
    gradient through K1 + K4, equal to the plain path's."""
    from interspeech_ser_tpu_torch.models import lora
    from interspeech_ser_tpu_torch.models.whisper import WhisperEncoderConfig, WhisperEncoderModel

    cfg = WhisperEncoderConfig(num_mel_bins=16, d_model=128, encoder_layers=2, encoder_attention_heads=2,
                               encoder_ffn_dim=256, max_source_positions=150)
    torch.manual_seed(0)
    model = WhisperEncoderModel(cfg).cuda().requires_grad_(False)
    factors = lora.init_lora(torch.Generator().manual_seed(0), model.state_dict(), lora.match_attention_qv, 4)
    for pair in factors.values():
        pair["lora_B"].normal_(std=0.1)
    mel = torch.randn(2, 16, 300, generator=cuda, device="cuda")
    gy = torch.randn(2, 150, 128, generator=cuda, device="cuda")
    grads = []
    for plain in (False, True):
        leaves = {p: {n: t.detach().cuda().requires_grad_() for n, t in pair.items()} for p, pair in factors.items()}
        before = k_attn.BWD_LAUNCHES
        merged = lora.merge_lora(lora.lora_targets(model.state_dict(), leaves), leaves, 16.0, 4)
        out = torch.func.functional_call(model, merged, (mel,), {"plain": plain})["last_hidden_state"]
        (out * gy).sum().backward()
        assert k_attn.BWD_LAUNCHES == before + (0 if plain else cfg.encoder_layers)
        grads.append({(p, n): t.grad for p, pair in leaves.items() for n, t in pair.items()})
    for key, got in grads[0].items():
        want = grads[1][key]
        assert got is not None and float(got.abs().max()) > 0, key
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), key


def _frontend_layers(gen, depth):
    """The zoo's frontend geometry at 512 channels: conv0 (k=10, s=5) then
    k = 3,3,3,3,2,2 with s = 2, conv biases on."""
    kernels, strides = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)
    layers = []
    for i in range(depth):
        c_in, k = (1 if i == 0 else 512), kernels[i]
        layers.append(k_conv.FrontendLayer(
            torch.randn(512, c_in, k, generator=gen, device="cuda") / (c_in * k) ** 0.5,
            0.1 * torch.randn(512, generator=gen, device="cuda"),
            1 + 0.1 * torch.randn(512, generator=gen, device="cuda"),
            0.1 * torch.randn(512, generator=gen, device="cuda"), strides[i]))
    return layers


@pytest.mark.parametrize("B,L", [(2, 16007), (1, 16017), (3, 1999)])
@pytest.mark.parametrize("depth", range(1, 8))
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_frontend_kernel(cuda, approx, dtype, depth, B, L):
    """T0 = 3200, 3202 (off the layer-0 kernel's 4-frame step and 64-frame
    chunk) at B = 1 and 398 at B = 3 (a block's run of frames crosses batch
    rows); a rerun is bit-identical."""
    wav = torch.randn(B, L, generator=cuda, device="cuda")
    args = (wav, _frontend_layers(cuda, depth), dtype, approx, 1e-5)
    before = (k_conv.LAUNCHES, k_conv.LAYER_LAUNCHES)
    out = k_conv.conv_frontend(*args)
    torch.cuda.synchronize()
    assert (k_conv.LAUNCHES, k_conv.LAYER_LAUNCHES) == (before[0] + 1, before[1] + depth - 1)
    ref = k_conv.conv_frontend_plain(*args)
    assert out.shape == ref.shape and out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        assert torch.nn.functional.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0) >= 0.999
    assert torch.equal(out, k_conv.conv_frontend(*args))  # no atomics: a rerun is bit-identical


@pytest.mark.parametrize("approx", [False, True])
def test_conv_frontend_gelu_table(cuda, approx):
    """The bf16 layer-0 kernel's GELU table (the erf or tanh expression of
    each of the 65,536 bf16 z, rounded) against ``F.gelu`` on the same bf16
    values: at most one bf16 ulp apart on every finite z (torch groups the
    tanh form's cube differently)."""
    got = k_conv.gelu_table(approx)
    z = torch.arange(65536, dtype=torch.int32, device="cuda").to(torch.int16).view(torch.bfloat16)
    want = torch.nn.functional.gelu(z, approximate="tanh" if approx else "none")
    keep = torch.isfinite(z) & torch.isfinite(want)

    def order(t):  # bf16 values as integers in their order (-0 and +0 both 0)
        b = t.view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)

    assert int((order(got) - order(want)).abs()[keep].max()) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_plans_match_build(cuda, dtype):
    """K8's and K2's layer-0 plans: the built kernel's threads and shared
    bytes are the plan's, and at least the plan's blocks an SM fit."""
    for c in k_pos.GROUP_WIDTHS:
        for K in (2, 127, 128, 256):
            plan = k_pos.pos_conv_plan(c, K, dtype)
            built = k_pos.pos_conv_occupancy(plan)
            assert built[:2] == (plan.threads, plan.smem_bytes) and built[2] >= plan.blocks_per_sm, (plan, built)
    for ksize in (3, 10, 16):
        plan = k_conv.conv_frontend_plan(8, 31999, dtype, ksize)
        built = k_conv.conv_frontend_occupancy(dtype, ksize, ksize == 3)
        assert built[:2] == (plan.threads, plan.smem_bytes) and built[2] >= plan.blocks_per_sm, (plan, built)


@pytest.mark.parametrize("hd", [80, 120])
@pytest.mark.parametrize("bias,masked", [(True, True), (False, True), (False, False), (False, "dead")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_wide_heads(cuda, hd, bias, masked, dtype):
    """K1 at HuBERT-XL's and XLS-R-2B's head dims (f32: 32-key tiles, hd/16 output columns a thread)."""
    B, T, H = 3, 150, 2
    q, k, v = (torch.randn(B, T, hd * H, generator=cuda, device="cuda").to(dtype) for _ in range(3))
    kw = {}
    if masked:
        kw["key_mask"] = _key_mask(T, masked)
    if bias:
        kw["gate"] = 1 + torch.rand(B, H, T, generator=cuda, device="cuda")
        kw["pos_bias"] = torch.randn(H, T, T, generator=cuda, device="cuda")
    out = k_attn.attention_btd(q, k, v, H, **kw)
    ref = k_attn.attention_btd_plain(q, k, v, H, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        assert torch.nn.functional.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0) >= 0.999
    if masked == "dead":
        _assert_dead_row(out, ref, dtype, "out")
    out, lse = k_attn.attention_btd_fwd(q, k, v, H, **kw)  # the lse is the row's, written once
    assert lse.shape == (B, H, T)
    if not bias and not masked and dtype == torch.float32:
        s = (q.view(B, T, H, hd).transpose(1, 2) * hd ** -0.5) @ k.view(B, T, H, hd).permute(0, 2, 3, 1)
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-4, rtol=0)


@pytest.mark.parametrize("hd", [80, 120])
def test_attention_train_takes_wide_heads(cuda, hd):
    """AttentionBtdTrain (K1 + K4) at HuBERT-XL's and XLS-R-2B's head dims,
    scale left to its default hd ** -0.5, against autograd through the plain
    forward (f32)."""
    (q, k, v, g, _), kw = _attention_bwd_inputs(cuda, True, True, torch.float32, H=2, hd=hd)
    grads = []
    for fn in (k_attn.AttentionBtdTrain.apply, k_attn.attention_btd_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, kw["gate"], kw["pos_bias"])]
        out = fn(*leaves[:3], 2, kw["key_mask"], None, leaves[3], leaves[4])
        grads.append(torch.autograd.grad(out, leaves, g))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("hd", [80, 120])
@pytest.mark.parametrize("bias,masked", [(True, True), (False, True), (False, False), (False, "dead")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_wide_heads(cuda, hd, bias, masked, dtype):
    """K4 at head dims 80 and 120 (register micro-tiles on the FP32 pipes in f32,
    the tensor cores in bf16) against the plain backward; a rerun is bit-identical."""
    (q, k, v, g, H), kw = _attention_bwd_inputs(cuda, bias, masked, dtype, H=2, hd=hd)
    out, lse = k_attn.attention_btd_fwd(q, k, v, H, **kw)
    got = k_attn.attention_btd_bwd(q, k, v, g, H, **kw, out=out, lse=lse)
    ref = k_attn.attention_btd_bwd_plain(q, k, v, g, H, **kw)
    _assert_bwd_close(got, ref, dtype, masked)
    again = k_attn.attention_btd_bwd(q, k, v, g, H, **kw, out=out, lse=lse)
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("hd", [64, 80, 120])
@pytest.mark.parametrize("T", [499, 1500])
def test_attention_tensor_cores_main_shapes(cuda, hd, T):
    """bf16 K1 and K4 (the tensor-core kernels) at every head dim and both
    lengths (neither a multiple of the 64-key tile), gated bias, H=16, with
    row 1's keys all masked: every row against the plain versions (cosine >=
    0.999), the dead row as the TPU kernel gives it (sum(V) / Tk_p, lse
    -inf, and P = 1 / Tk_p in the backward, so its keys get gradients)."""
    B, H = 3, 16
    (q, k, v, g, _), kw = _attention_bwd_inputs(cuda, True, False, torch.bfloat16, B=B, T=T, H=H, hd=hd)
    kw["key_mask"] = (torch.arange(T, device="cuda")[None] < torch.tensor([T, 0, T // 3], device="cuda")[:, None]).float()
    out, lse = k_attn.attention_btd_fwd(q, k, v, H, **kw)
    ref = k_attn.attention_btd_plain(q, k, v, H, **kw)
    cos = torch.nn.functional.cosine_similarity
    assert cos(out.float().flatten(), ref.float().flatten(), dim=0) >= 0.999
    assert cos(out[1].float().flatten(), ref[1].float().flatten(), dim=0) >= 0.999
    _assert_dead_row(out, ref, torch.bfloat16, "out")
    assert bool(torch.isinf(lse[1]).all())
    got = k_attn.attention_btd_bwd(q, k, v, g, H, **kw, out=out, lse=lse)
    want = k_attn.attention_btd_bwd_plain(q, k, v, g, H, **kw)
    for name, a, b in zip(("dq", "dk", "dv", "dgate", "dbias"), got, want):
        assert cos(a.float().flatten(), b.float().flatten(), dim=0) >= 0.999, name
        if name != "dbias":
            assert cos(a[1].float().flatten(), b[1].float().flatten(), dim=0) >= 0.999, name
            _assert_dead_row(a, b, torch.bfloat16, name)


@pytest.mark.parametrize("hd", [64, 80, 120])
@pytest.mark.parametrize("T", [1500, 499, 77])
@pytest.mark.parametrize("bias", [False, True])
def test_attention_btd_f32_main_shapes(cuda, hd, T, bias):
    """f32 K1 and K4 (the FP32-pipe micro-tile kernels) at every head dim and
    T = 1500, 499 and 77 (none a multiple of the 64-, 32- or 16-row tiles),
    with and without the gated bias. Key mask: row 0 keeps every key, row 1
    none (sum(V) / Tk_p, lse -inf, P = 1 / Tk_p in the backward), row 2 stops
    before its last 64-key tile, which is then fully masked (and so are its
    32- and 16-key tiles). T = 1500 and 499 span several 128-row blocks. Bars: K1 atol 1e-4 against attention_btd_plain,
    the dead row 1e-5; K4 max-abs <= 1e-5 x max|ref| per output; K1 and K4
    reruns bit-identical."""
    B, H = 3, 2
    (q, k, v, g, _), kw = _attention_bwd_inputs(cuda, bias, False, torch.float32, B=B, T=T, H=H, hd=hd)
    lengths = [T, 0, (T - 1) // 64 * 64 - 5]
    kw["key_mask"] = (torch.arange(T, device="cuda")[None] < torch.tensor(lengths, device="cuda")[:, None]).float()
    out, lse = k_attn.attention_btd_fwd(q, k, v, H, **kw)
    out2, lse2 = k_attn.attention_btd_fwd(q, k, v, H, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref = k_attn.attention_btd_plain(q, k, v, H, **kw)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    _assert_dead_row(out, ref, torch.float32, "out")
    assert bool(torch.isinf(lse[1]).all()) and bool(torch.isfinite(lse[0]).all() and torch.isfinite(lse[2]).all())
    got = k_attn.attention_btd_bwd(q, k, v, g, H, **kw, out=out, lse=lse)
    ref_b = k_attn.attention_btd_bwd_plain(q, k, v, g, H, **kw)
    _assert_bwd_close(got, ref_b, torch.float32, "dead")
    again = k_attn.attention_btd_bwd(q, k, v, g, H, **kw, out=out, lse=lse)
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("kind", k_attn.F32_KINDS)
def test_attention_btd_f32_plan_matches_the_build(cuda, kind):
    """The built f32 kernels take the tile and shared memory that
    attention_f32_plan gives, and a block of 256 threads is resident, one an
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers included)."""
    for hd in k_attn.K1_HEAD_DIMS:
        for bias in (False, True):
            plan = k_attn.attention_f32_plan(hd, bias, kind)
            tile, nbytes, blocks = k_attn.attention_f32_occupancy(hd, bias, kind)
            assert (tile, nbytes) == (plan.tile, plan.smem_bytes), (hd, bias)
            assert blocks == plan.blocks_per_sm == 1, (hd, bias, blocks)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_attention_btd_f32_refuses_views_off_16_bytes(cuda, offset):
    """An f32 panel that starts ``offset`` floats past a 16-byte boundary
    (contiguous all the same) is refused by K1 and K4 before any launch; the
    same values copied to an aligned tensor run."""
    T, H, hd = 77, 2, 64
    flat = torch.randn(T * H * hd + 8, generator=cuda, device="cuda")
    x = flat[offset:offset + T * H * hd].view(1, T, H * hd)
    assert x.data_ptr() % 16 == 4 * offset
    before = (k_attn.LAUNCHES, k_attn.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        k_attn.attention_btd(x, x, x, H)
    y = x.clone()
    out, lse = k_attn.attention_btd_fwd(y, y, y, H)
    with pytest.raises(ValueError, match="16-byte"):
        k_attn.attention_btd_bwd(x, y, y, y, H, out=out, lse=lse)
    assert (k_attn.LAUNCHES, k_attn.BWD_LAUNCHES) == (before[0] + 1, before[1])
    torch.testing.assert_close(out, k_attn.attention_btd_plain(y, y, y, H), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", k_ffn.WIDTHS)
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_fused_kernel(cuda, n, approx, dtype):
    """K5 with M, K and F off its tiles (300 rows: 3 clusters of 128, the last
    ragged; 104 inputs; 328 hidden: one chunk and a masked tail), K and F
    multiples of 8 as its 16-byte row copies need."""
    M, K, Fd = 300, 104, 328
    x = torch.randn(M, K, generator=cuda, device="cuda").to(dtype)
    w_up = torch.randn(Fd, K, generator=cuda, device="cuda") / K ** 0.5
    b_up = 0.1 * torch.randn(Fd, generator=cuda, device="cuda")
    w_down = torch.randn(n, Fd, generator=cuda, device="cuda") / Fd ** 0.5
    b_down = 0.1 * torch.randn(n, generator=cuda, device="cuda")
    args = (x, w_up, b_up, w_down, b_down, approx)
    before = k_ffn.LAUNCHES
    out = k_ffn.ffn_fused(*args)
    torch.cuda.synchronize()
    assert k_ffn.LAUNCHES == before + 1
    ref = k_ffn.ffn_fused_plain(*args)
    assert out.shape == (M, n) and out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        assert torch.nn.functional.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0) >= 0.999
    assert torch.equal(out, k_ffn.ffn_fused(*args))  # no atomics: a rerun is bit-identical


@pytest.mark.parametrize("c", k_pos.GROUP_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,B", [(3, 128, 2), (150, 128, 2), (1, 128, 2), ("tile-1", 128, 2), ("tile", 128, 2),
                                   (499, 128, 2), (150, 127, 1), ("tile", 127, 1), (150, 2, 2), (150, 256, 1)])
def test_pos_conv_kernel(cuda, c, dtype, T, K, B):
    """K8 at 16 groups of each width it takes, K = 128 taps (T = 3: fewer
    frames than taps; T + 1 output frames on both sides of the plan's frame
    tile), K = 127 (odd: T output frames) at B = 1, and K = 2 and 256 (the
    bf16 kernel's 3-step ring at C = 120); a rerun is bit-identical."""
    tile = k_pos.pos_conv_plan(c, K, dtype).frames
    T = {"tile-1": tile - 1, "tile": tile}.get(T, T)
    D = 16 * c
    x = torch.randn(B, T, D, generator=cuda, device="cuda").to(dtype)
    w = torch.randn(D, c, K, generator=cuda, device="cuda") / (c * K) ** 0.5
    before = k_pos.LAUNCHES
    out = k_pos.pos_conv(x, w, 16)
    torch.cuda.synchronize()
    assert k_pos.LAUNCHES == before + 1
    ref = k_pos.pos_conv_plain(x, w, 16)
    assert out.shape == ref.shape == (B, T + 1 - K % 2, D) and out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        assert torch.nn.functional.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0) >= 0.999
    assert torch.equal(out, k_pos.pos_conv(x, w, 16))  # no atomics: a rerun is bit-identical


@pytest.mark.parametrize("c", k_pos.GROUP_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [128, 127])
def test_pos_conv_weight_layout(cuda, c, dtype, src_dtype, K):
    """K8's tiled layout kernel gives the bits of torch's permuted copy:
    [G, K, C_out, C_in] for bf16, [G, C_in, K, C_out] for f32, the cast
    rounded to nearest even (K = 127 and the f32 layout's C_out rows leave
    part-filled 32 x 32 tiles)."""
    w = (torch.randn(16 * c, c, K, generator=cuda, device="cuda") / (c * K) ** 0.5).to(src_dtype)
    g = w.view(16, c, c, K)
    want = g.permute(0, 3, 1, 2) if dtype == torch.bfloat16 else g.permute(0, 2, 3, 1)
    want = torch.empty(want.shape, dtype=dtype, device="cuda").copy_(want)
    got = k_pos.weight_layout(w, 16, dtype)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, want)


def test_pos_conv_refuses_a_weight_on_another_device(cuda):
    x = torch.randn(1, 5, 768, device="cuda")
    with pytest.raises(ValueError, match="weight on cpu"):
        k_pos.pos_conv(x, torch.randn(768, 48, 128), 16)


def test_inference_kernels_refuse_grad(cuda):
    x = torch.randn(4, 96, device="cuda", requires_grad=True)
    w = torch.randn(768, 96, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        k_ffn.ffn_fused(x, w, torch.zeros(768, device="cuda"), w, torch.zeros(768, device="cuda"), False)
    y = torch.randn(1, 5, 768, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        k_pos.pos_conv(y, torch.randn(768, 48, 128, device="cuda"), 16)
    with pytest.raises(RuntimeError, match="no backward"):
        k_gru.gru_sequence(torch.randn(2, 5, 12, device="cuda", requires_grad=True), torch.randn(4, 12, device="cuda"),
                           torch.zeros(12, device="cuda"))


def test_gru_kernel(cuda):
    B, T, H = 3, 40, 64
    x = torch.randn(2 * B, T, 3 * H, generator=cuda, device="cuda")
    w = (torch.rand(2, H, 3 * H, generator=cuda, device="cuda") - 0.5) / 4
    b = (torch.rand(2, 3 * H, generator=cuda, device="cuda") - 0.5) / 4
    m = (torch.arange(T, device="cuda")[None] < torch.tensor([40, 17, 3], device="cuda")[:, None]).float()
    mask = torch.cat([m, m.flip(1)]).contiguous()
    out = k_gru.gru_sequence_bidir(x, w, b, mask, B)
    ref = k_gru.gru_bidir_carries_plain(x, w, b, mask) * mask[:, :, None]
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,T,H", [(37, 50, 512), (3, 40, 64), (5, 30, 100), (3, 20, 640)])
def test_gru_kernel_routes(cuda, B, T, H):
    """K3 on both routes of its launch planner (H=640 takes one block a row,
    the rest a cluster), with 2B not a multiple of the cluster's 16 rows and
    masks with holes (not prefixes), against the plain version."""
    x = 0.5 * torch.randn(2 * B, T, 3 * H, generator=cuda, device="cuda")
    w = (torch.rand(2, H, 3 * H, generator=cuda, device="cuda") * 2 - 1) * H ** -0.5
    b = (torch.rand(2, 3 * H, generator=cuda, device="cuda") * 2 - 1) * H ** -0.5
    mask = (torch.rand(2 * B, T, generator=cuda, device="cuda") > 0.3).float()
    mask[1, : T // 2] = 0  # a row that starts late
    plan = k_gru.gru_bidir_plan(2 * B, H)
    assert plan.route == ("row" if H > 512 else "cluster")
    before = k_gru.LAUNCHES
    out = k_gru.gru_bidir_carries(x, w, b, mask)
    torch.cuda.synchronize()
    assert k_gru.LAUNCHES == before + 1
    torch.testing.assert_close(out, k_gru.gru_bidir_carries_plain(x, w, b, mask), atol=1e-5, rtol=0)


def test_gru_cluster_occupancy(cuda):
    """The card holds at least one cluster of the widest cluster route (16 CTAs of 226 KB)."""
    assert k_gru.max_active_clusters(512) >= 1
    with pytest.raises(ValueError):
        k_gru.max_active_clusters(640)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_sequence_kernel(cuda, reverse):
    """K9, one direction, ragged prefix masks (row 2 runs 3 of 40 steps)."""
    B, T, H = 3, 40, 64
    x = torch.randn(B, T, 3 * H, generator=cuda, device="cuda")
    w = (torch.rand(H, 3 * H, generator=cuda, device="cuda") - 0.5) / 4
    b = (torch.rand(3 * H, generator=cuda, device="cuda") - 0.5) / 4
    m = (torch.arange(T, device="cuda")[None] < torch.tensor([40, 17, 3], device="cuda")[:, None]).float()
    before = k_gru.SEQ_LAUNCHES
    out = k_gru.gru_sequence(x, w, b, m, reverse)
    torch.cuda.synchronize()
    assert k_gru.SEQ_LAUNCHES == before + 1
    torch.testing.assert_close(out, k_gru.gru_sequence_plain(x, w, b, m, reverse), atol=1e-5, rtol=0)
    assert float(out[2, 3:].abs().max()) == 0.0


def _gru_bwd_inputs(gen, B=3, T=40, H=64):
    x = torch.randn(2 * B, T, 3 * H, generator=gen, device="cuda")
    w = (torch.rand(2, H, 3 * H, generator=gen, device="cuda") - 0.5) / 4
    b = (torch.rand(2, 3 * H, generator=gen, device="cuda") - 0.5) / 4
    m = (torch.arange(T, device="cuda")[None] < torch.tensor([40, 17, 3], device="cuda")[:, None]).float()
    return x, w, b, torch.cat([m, m.flip(1)]).contiguous()


def test_gru_bwd_kernel(cuda):
    """K3b against the plain backward; dW/db in fixed order, so a rerun is bit-identical."""
    x, w, b, mask = _gru_bwd_inputs(cuda)
    h = k_gru.gru_bidir_carries(x, w, b, mask)
    g = torch.randn(h.shape, generator=cuda, device="cuda")
    before = k_gru.BWD_LAUNCHES
    out = k_gru.gru_bidir_carries_bwd(x, w, b, mask, h, g)
    torch.cuda.synchronize()
    assert k_gru.BWD_LAUNCHES == before + 1
    ref = k_gru.gru_bidir_carries_bwd_plain(x, w, b, mask, h, g)
    for got, want in zip(out, ref):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert all(torch.equal(a, c) for a, c in zip(out, k_gru.gru_bidir_carries_bwd(x, w, b, mask, h, g)))


def test_gru_function_grads_match_plain_autograd(cuda):
    """The Function (K3 + K3b) against autograd through the plain forward."""
    x, w, b, mask = _gru_bwd_inputs(cuda)
    g = torch.randn(x.shape[0], x.shape[1], w.shape[1], generator=cuda, device="cuda")
    grads = []
    for fn in (k_gru.GruBidirCarries.apply, k_gru.gru_bidir_carries_plain):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        out = fn(*leaves, mask) * mask[:, :, None]
        grads.append(torch.autograd.grad(out, leaves, g))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_bigru_gets_gradients_on_the_card(cuda):
    """Every BiGRU parameter and the input get the CPU path's gradient (autograd through gru_scan)."""
    from interspeech_ser_tpu_torch.ops.gru import BiGRU

    torch.manual_seed(0)
    cpu = BiGRU(24, 32)
    card = BiGRU(24, 32).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 30, 24)
    m = (torch.arange(30)[None] < torch.tensor([30, 11, 4])[:, None]).float()
    gy = torch.randn(3, 30, 64)
    xs = [x.clone().requires_grad_(), x.cuda().requires_grad_()]
    before = k_gru.BWD_LAUNCHES
    (cpu(xs[0], m) * gy).sum().backward()
    (card(xs[1], m.cuda()) * gy.cuda()).sum().backward()
    assert k_gru.BWD_LAUNCHES == before + 1
    torch.testing.assert_close(xs[1].grad.cpu(), xs[0].grad, atol=1e-5, rtol=1e-4)
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        assert q.grad is not None, name
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-5, rtol=1e-4, msg=name)


def _edge_mask(gen, B2, T):
    """Holes anywhere (not prefixes), a row masked from step 0 to the middle,
    a step masked in every row."""
    mask = (torch.rand(B2, T, generator=gen, device="cuda") > 0.3).float()
    mask[1, : T // 2] = 0
    mask[:, T // 3] = 0
    return mask.contiguous()


@pytest.mark.parametrize("B,T,H", [(37, 50, 512), (3, 40, 64), (5, 30, 100), (4, 17, 40), (3, 20, 640), (2, 1, 96),
                                   (2, 12, 3000)])
def test_gru_bwd_kernel_routes(cuda, B, T, H):
    """K3b on both routes of its planner (H <= 512 a cluster, above one block
    a row, up to K3's 4096), 2B = 74 (a partial row group), H not a multiple
    of 32, T = 1 and the edge masks, against the plain backward; reruns give
    the same bits."""
    x = 0.5 * torch.randn(2 * B, T, 3 * H, generator=cuda, device="cuda")
    w = (torch.rand(2, H, 3 * H, generator=cuda, device="cuda") * 2 - 1) * H ** -0.5
    b = (torch.rand(2, 3 * H, generator=cuda, device="cuda") * 2 - 1) * H ** -0.5
    mask = _edge_mask(cuda, 2 * B, T)
    h = k_gru.gru_bidir_carries(x, w, b, mask)
    g = torch.randn(h.shape, generator=cuda, device="cuda")
    assert k_gru.gru_bidir_bwd_plan(2 * B, H).route == ("row" if H > 512 else "cluster")
    before = k_gru.BWD_LAUNCHES
    out = k_gru.gru_bidir_carries_bwd(x, w, b, mask, h, g)
    torch.cuda.synchronize()
    assert k_gru.BWD_LAUNCHES == before + 1
    ref = k_gru.gru_bidir_carries_bwd_plain(x, w, b, mask, h, g)
    for name, got, want in zip(("dx_proj", "dW_hh2", "db_hh2"), out, ref):
        scale = max(1.0, float(want.abs().max())) if name == "dx_proj" else float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale, name
    assert float(out[0][mask == 0].abs().max()) == 0.0  # a masked step has no input gradient
    assert all(torch.equal(a, c) for a, c in zip(out, k_gru.gru_bidir_carries_bwd(x, w, b, mask, h, g)))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H", [(37, 50, 512), (5, 30, 100), (3, 20, 640)])
def test_gru_sequence_kernel_routes(cuda, B, T, H, reverse):
    """K9 on both routes of its planner, with the edge masks and with no mask
    (all ones), against the plain version."""
    x = 0.5 * torch.randn(B, T, 3 * H, generator=cuda, device="cuda")
    w = (torch.rand(H, 3 * H, generator=cuda, device="cuda") * 2 - 1) * H ** -0.5
    b = (torch.rand(3 * H, generator=cuda, device="cuda") * 2 - 1) * H ** -0.5
    assert k_gru.gru_sequence_plan(B, H).route == ("row" if H > 512 else "cluster")
    for mask in (_edge_mask(cuda, B, T), None):
        before = k_gru.SEQ_LAUNCHES
        out = k_gru.gru_sequence(x, w, b, mask, reverse)
        torch.cuda.synchronize()
        assert k_gru.SEQ_LAUNCHES == before + 1
        torch.testing.assert_close(out, k_gru.gru_sequence_plain(x, w, b, mask, reverse), atol=1e-5, rtol=0)
        if mask is not None:
            assert float(out[mask == 0].abs().max()) == 0.0


@pytest.mark.parametrize("kernel", ["gru_sequence", "gru_bidir_bwd"])
def test_gru_new_cluster_routes_occupancy(cuda, kernel):
    """The card holds at least one cluster of 16 CTAs of K9's and K3b's cluster routes."""
    assert k_gru.max_active_clusters(512, kernel) >= 1
    with pytest.raises(ValueError):
        k_gru.max_active_clusters(640, kernel)


def test_gru_launcher_refuses_grad(cuda):
    x, w, b, mask = _gru_bwd_inputs(cuda)
    with pytest.raises(RuntimeError, match="GruBidirCarries"):
        k_gru.gru_bidir_carries(x.requires_grad_(), w, b, mask)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 8, 96, device="cuda")
    with pytest.raises(NotImplementedError):
        k_attn.attention_btd(q, q, q, 2)  # head dim 48
    with pytest.raises(ValueError):
        k_attn.attention_btd(q[:, :, :64].contiguous(), q[:, :, :64], q[:, :, :64], 1)  # non-contiguous k
    flat = torch.randn(8 * 64 + 1, device="cuda").to(torch.bfloat16)
    odd = flat[1:].view(1, 8, 64)  # contiguous, but 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        k_attn.attention_btd(odd, odd, odd, 1)
    with pytest.raises(ValueError):
        k_gru.gru_bidir_carries(torch.randn(3, 4, 6, device="cuda"), torch.randn(2, 2, 6, device="cuda"),
                                torch.randn(2, 6, device="cuda"), torch.ones(3, 4, device="cuda"))
    h = torch.randn(4, 5, 8, device="cuda")
    with pytest.raises(ValueError):  # K3b's stages: dhp is [2B, T, 3H]
        k_gru.bwd_weight_grads(h, torch.randn(4, 5, 23, device="cuda"))
    with pytest.raises(ValueError):
        k_gru.gate_preacts(h, torch.randn(2, 8, 24, device="cuda"), torch.randn(2, 24, device="cuda").double())
    # K6 in bf16 copies rows by 16-byte cp.async: a head view 2 bytes off, or a time
    # stride of 68 elements, is refused (K7 and f32 K6 take both)
    heads = torch.randn(1, 8 * 64 + 1, device="cuda").to(torch.bfloat16)[:, 1:].view(1, 1, 8, 64)
    wide = torch.randn(1, 8, 68, device="cuda").to(torch.bfloat16)[:, :, :64].unsqueeze(1)
    for bad in (heads, wide):
        with pytest.raises(ValueError, match="16 bytes"):
            k_bhtd.flash_attention(bad, bad, bad)
        k_bhtd.attention_bhtd(bad, bad, bad)
        k_bhtd.flash_attention(bad.float(), bad.float(), bad.float())
    # K5 takes K and F in multiples of 8
    with pytest.raises(NotImplementedError, match="multiples of 8"):
        k_ffn.ffn_fused(torch.randn(4, 100, device="cuda"), torch.randn(300, 100, device="cuda"),
                        torch.zeros(300, device="cuda"), torch.randn(768, 300, device="cuda"),
                        torch.zeros(768, device="cuda"), False)


BHTD = {"oneshot": (k_bhtd.attention_bhtd, k_bhtd.attention_bhtd_plain, "LAUNCHES"),
        "flash": (k_bhtd.flash_attention, k_bhtd.flash_attention_plain, "FLASH_LAUNCHES")}


@pytest.mark.parametrize("kernel", list(BHTD))
@pytest.mark.parametrize("bias,masked", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk", [(80, 80), (150, 217), (70, 499)])
def test_bhtd_kernels(cuda, kernel, bias, masked, dtype, tq, tk):
    """K7 / K6 on [B, H, T, 64] heads, Tk never a multiple of the 64-key tile;
    row 2 of the mask leaves whole 64-key tiles masked, row 3 masks every key
    (sum(V) / Tk_p: the TPU kernels' padded keys count)."""
    fn, plain, counter = BHTD[kernel]
    B, H = 4, 3
    q = torch.randn(B, H, tq, 64, generator=cuda, device="cuda").to(dtype)
    k, v = (torch.randn(B, H, tk, 64, generator=cuda, device="cuda").to(dtype) for _ in range(2))
    kw = {}
    if masked:
        kw["key_mask"] = (torch.arange(tk, device="cuda")[None]
                          < torch.tensor([tk, tk - 9, 30, 0], device="cuda")[:, None]).float()
    if bias:
        kw["gate"] = 1 + torch.rand(B, H, tq, generator=cuda, device="cuda")
        kw["pos_bias"] = torch.randn(H, tq, tk, generator=cuda, device="cuda")
    before = getattr(k_bhtd, counter)
    out = fn(q, k, v, **kw)
    torch.cuda.synchronize()
    assert getattr(k_bhtd, counter) == before + 1
    ref = plain(q, k, v, **kw)
    assert out.shape == ref.shape == (B, H, tq, 64) and out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        assert torch.nn.functional.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0) >= 0.9999
    if masked:
        _assert_dead_row(out, ref, dtype, kernel, row=3)


@pytest.mark.parametrize("kernel", list(BHTD))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["btd", "qkv"])
def test_bhtd_kernels_take_strided_projections(cuda, kernel, dtype, layout):
    """[B, T, H*64] projections viewed as [B, H, T, 64] (RoBERTa's layout), or
    q, k, v cut from one [B, T, 3, H, 64] projection, give the same result as
    contiguous heads, and the output's transpose back to [B, T, D] is a free view."""
    fn, _, _ = BHTD[kernel]
    B, T, H = 3, 80, 4
    if layout == "btd":
        q, k, v = (torch.randn(B, T, H * 64, generator=cuda, device="cuda").to(dtype) for _ in range(3))
        views = [t.view(B, T, H, 64).transpose(1, 2) for t in (q, k, v)]
    else:
        qkv = torch.randn(B, T, 3, H, 64, generator=cuda, device="cuda").to(dtype)
        views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    out = fn(*views)
    torch.testing.assert_close(out, fn(*(t.contiguous() for t in views)), atol=0, rtol=0)
    assert out.transpose(1, 2).is_contiguous()


def test_bhtd_long_keys(cuda):
    """K6 at a length K7 refuses, and K7 at its limit (in f32 its two-pass route)."""
    q = torch.randn(1, 2, 70, 64, generator=cuda, device="cuda")
    k, v = (torch.randn(1, 2, 2500, 64, generator=cuda, device="cuda") for _ in range(2))
    torch.testing.assert_close(k_bhtd.flash_attention(q, k, v), k_bhtd.flash_attention_plain(q, k, v),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        k_bhtd.attention_bhtd(q, k, v)
    k, v = k[:, :, :2048], v[:, :, :2048]
    torch.testing.assert_close(k_bhtd.attention_bhtd(q, k, v), k_bhtd.attention_bhtd_plain(q, k, v),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("tk", [80, 499, 2048])
@pytest.mark.parametrize("offset", [False, True])
def test_oneshot_bf16_tensor_cores(cuda, tk, offset):
    """K7 in bf16 (mma.sync; scores in registers at Tk <= 128, two passes
    above) with the gated bias and a ragged mask whose row 1 has no live key,
    on views one element off 16 bytes (staged by 2-byte loads) or aligned."""
    B, H, tq = 3, 2, min(tk, 150)
    n = B * tk * H * 64
    q = torch.randn(B * tq * H * 64 + offset, generator=cuda, device="cuda").to(torch.bfloat16)[int(offset):]
    q = q.view(B, tq, H, 64).transpose(1, 2)
    k, v = (torch.randn(n + offset, generator=cuda, device="cuda").to(torch.bfloat16)[int(offset):]
            .view(B, tk, H, 64).transpose(1, 2) for _ in range(2))
    assert (q.data_ptr() % 16 != 0) == offset
    kw = dict(key_mask=(torch.arange(tk, device="cuda")[None]
                        < torch.tensor([tk, 0, tk // 3], device="cuda")[:, None]).float(),
              gate=1 + torch.rand(B, H, tq, generator=cuda, device="cuda"),
              pos_bias=torch.randn(H, tq, tk, generator=cuda, device="cuda"))
    out = k_bhtd.attention_bhtd(q, k, v, **kw)
    ref = k_bhtd.attention_bhtd_plain(q, k, v, **kw)
    assert torch.nn.functional.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0) >= 0.9999
    _assert_dead_row(out, ref, torch.bfloat16, "oneshot", row=1)


def _bhtd_f32_inputs(g, B, H, tq, tk, lengths, bias, offset=0):
    """f32 [B, H, T, 64] heads viewed out of [B, T, H*64] buffers that start
    ``offset`` floats past a 16-byte boundary, a key mask from ``lengths`` and
    the gated bias."""
    def heads(T):
        flat = torch.randn(B * T * H * 64 + 4, generator=g, device="cuda")
        return flat[offset:offset + B * T * H * 64].view(B, T, H, 64).transpose(1, 2)

    q, k, v = heads(tq), heads(tk), heads(tk)
    kw = {}
    if lengths is not None:
        kw["key_mask"] = (torch.arange(tk, device="cuda")[None] < torch.tensor(lengths, device="cuda")[:, None]).float()
    if bias:
        kw["gate"] = 1 + torch.rand(B, H, tq, generator=g, device="cuda")
        kw["pos_bias"] = torch.randn(H, tq, tk, generator=g, device="cuda")
    return (q, k, v), kw


@pytest.mark.parametrize("kernel", list(BHTD))
@pytest.mark.parametrize("tk", [1, 63, 64, 65, 128, 255, 256, 257, 499, 512, 513, 640, 641])
@pytest.mark.parametrize("bias", [False, True])
def test_bhtd_f32_route_boundary(cuda, kernel, tk, bias):
    """f32 K7 on both sides of each of its route boundaries (scores on chip
    in 128-row blocks up to Tk = 256, in 80-row ones up to 512, in 64-row ones
    up to 640, two passes above) and K6 at the same lengths, each against its
    plain version (atol 1e-5), at Tq = 64, 80 and 150, so that every block
    size (64, 80, 128 rows) meets every route; Tq = 150 spans two 128-row
    blocks; row 1 of the mask has no live key (sum(V) / Tk_p, atol 1e-5),
    row 2 leaves whole 64-key tiles masked above Tk = 64."""
    fn, plain, _ = BHTD[kernel]
    lengths = [tk, 0, max(1, tk // 5)]
    for tq in (64, 80, 150):
        args, kw = _bhtd_f32_inputs(cuda, 3, 2, tq, tk, lengths, bias)
        out = fn(*args, **kw)
        ref = plain(*args, **kw)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        _assert_dead_row(out, ref, torch.float32, kernel, row=1)


@pytest.mark.parametrize("kernel", list(BHTD))
@pytest.mark.parametrize("tk", [80, 499])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_bhtd_f32_takes_views_off_16_bytes(cuda, kernel, tk, offset):
    """f32 K6 and K7 on views ``offset`` floats past a 16-byte boundary (their
    4-byte cp.async route) with the gated bias and a dead row: within 1e-5 of
    the plain version, and bit-identical to the same values copied to aligned
    tensors (the 16-byte route), launched once each."""
    fn, plain, counter = BHTD[kernel]
    lengths = [tk, 0, tk // 3]
    args, kw = _bhtd_f32_inputs(cuda, 3, 2, 90, tk, lengths, True, offset)
    assert all(t.data_ptr() % 16 == 4 * offset for t in args)
    before = getattr(k_bhtd, counter)
    out = fn(*args, **kw)
    aligned = [t.contiguous() for t in args]
    assert all(t.data_ptr() % 16 == 0 for t in aligned)
    out_aligned = fn(*aligned, **kw)
    assert getattr(k_bhtd, counter) == before + 2
    assert torch.equal(out, out_aligned)
    ref = plain(*args, **kw)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    _assert_dead_row(out, ref, torch.float32, kernel, row=1)


def test_oneshot_f32_longest_keys_with_bias(cuda):
    """f32 K7 at its longest key length, Tk = 2048 (two passes), with the gated
    bias and a ragged mask whose row 1 has no live key; rerun bit-identical."""
    args, kw = _bhtd_f32_inputs(cuda, 2, 2, 200, 2048, [2048, 0], True)
    out = k_bhtd.attention_bhtd(*args, **kw)
    assert torch.equal(out, k_bhtd.attention_bhtd(*args, **kw))
    ref = k_bhtd.attention_bhtd_plain(*args, **kw)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    _assert_dead_row(out, ref, torch.float32, "oneshot", row=1)


@pytest.mark.parametrize("kernel", ["attention_bhtd", "flash_attention"])
def test_bhtd_f32_plan_matches_the_build(cuda, kernel):
    """The built f32 launchers pick the route, block rows, tile and shared
    memory that bhtd_f32_plan gives, and their kernel is resident (at least
    one block an SM, registers included), at (Tq, Tk) that reach every
    block size on each route."""
    for tq, tk in ((80, 80), (64, 640), (80, 513), (150, 1), (499, 256), (499, 257), (1500, 1500), (24, 2048),
                   (80, 1000)):
        if kernel == "attention_bhtd" and tk > k_bhtd.MAX_ONESHOT_TK:
            continue
        for bias in (False, True):
            plan = k_bhtd.bhtd_f32_plan(kernel, tq, tk, bias)
            route, r, tile, nbytes, blocks = k_bhtd.bhtd_f32_occupancy(kernel, tq, tk, bias)
            assert (route, r, tile, nbytes) == (plan.route, plan.rows, plan.tile, plan.smem_bytes), (tq, tk, bias)
            assert blocks >= 1, (tq, tk, bias)


def test_bhtd_launchers_refuse_grad_and_bad_shapes(cuda):
    q = torch.randn(1, 2, 10, 64, device="cuda", requires_grad=True)
    for fn, _, _ in BHTD.values():
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q, q.detach(), q.detach())
        with pytest.raises(NotImplementedError):
            x = torch.randn(1, 2, 10, 32, device="cuda")
            fn(x, x, x)  # head dim 32


def test_roberta_on_the_card_matches_the_plain_path(cuda, monkeypatch):
    """A 2-layer RoBERTa at head dim 64 on the card: K7 by default, K6 under
    SER_TPU_ATTN_IMPL=flash, both against plain=True."""
    from interspeech_ser_tpu_torch.models.text import RobertaConfig, RobertaModel

    torch.manual_seed(0)
    model = RobertaModel(RobertaConfig(vocab_size=100, hidden_size=256, num_layers=2, num_heads=4,
                                       intermediate_size=512, max_position_embeddings=90)).cuda().eval()
    ids = torch.randint(3, 100, (5, 80), generator=cuda, device="cuda")
    mask = (torch.arange(80, device="cuda")[None] < torch.tensor([80, 41, 7, 64, 2], device="cuda")[:, None]).long()
    ids = torch.where(mask > 0, ids, torch.ones_like(ids))
    monkeypatch.delenv("SER_TPU_ATTN_IMPL", raising=False)
    with torch.inference_mode():
        ref = model(ids, mask, plain=True)["last_hidden_state"]
        before = (k_bhtd.LAUNCHES, k_bhtd.FLASH_LAUNCHES)
        out7 = model(ids, mask)["last_hidden_state"]
        monkeypatch.setenv("SER_TPU_ATTN_IMPL", "flash")
        out6 = model(ids, mask)["last_hidden_state"]
    assert (k_bhtd.LAUNCHES - before[0], k_bhtd.FLASH_LAUNCHES - before[1]) == (2, 2)
    torch.testing.assert_close(out7, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(out6, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("preset", ["xlsr_2b", "base"])
def test_zoo_encoder_on_the_card_matches_the_plain_path(cuda, preset, monkeypatch):
    """Two layers of XLS-R-2B at full width (K2 at depth 3, K1 at hd 120, K8
    at 120 channels a group, K5) and of the base shape (group norm, post-LN,
    no conv bias: no K2, K1 at hd 64, K8 at 48 channels), inference_kernels
    on, f32, against plain=True."""
    import dataclasses

    from interspeech_ser_tpu_torch.models import speech

    if preset == "xlsr_2b":
        cfg = dataclasses.replace(speech.wav2vec2_xlsr_2b(), num_layers=2, inference_kernels=True)
    else:
        cfg = speech.SpeechConfig(num_layers=2, attention_type="wavlm", inference_kernels=True)
    monkeypatch.setenv("SER_TPU_FFN_KERNEL", "1")
    monkeypatch.setenv("SER_TPU_FRONTEND", "3")
    torch.manual_seed(0)
    model = speech.SpeechEncoderModel(cfg).cuda().eval()
    wav = torch.randn(2, 32000, generator=cuda, device="cuda")
    mask = (torch.arange(32000, device="cuda")[None] < torch.tensor([32000, 20011], device="cuda")[:, None]).float()
    counters = [(k_attn, "LAUNCHES"), (k_conv, "LAUNCHES"), (k_conv, "LAYER_LAUNCHES"), (k_pos, "LAUNCHES"),
                (k_ffn, "LAUNCHES")]
    before = [getattr(m, c) for m, c in counters]
    with torch.inference_mode():
        res = model(wav, mask)
        torch.cuda.synchronize()
        launched = [getattr(m, c) - b for (m, c), b in zip(counters, before)]
        ref = model(wav, mask, plain=True)["last_hidden_state"]
    assert launched == [2, 1, 2, 1, 2] if preset == "xlsr_2b" else [2, 0, 0, 1, 2]
    out, valid = res["last_hidden_state"], res["frame_mask"] > 0
    err = float((out - ref).abs()[valid].max()) / float(ref.abs()[valid].max())
    assert err <= 1e-4, err
