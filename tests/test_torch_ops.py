"""The eval forward's kernels B4f, B5f and B6f as PyTorch operators
(``simclr_tpu_torch/ops/kernels/registry.py``), on the CPU.

* ``torch.library.opcheck`` passes for each operator on CPU tensors of a
  tiny shape: its schema, its fake kernel against its CPU kernel, and
  its dispatch under AOT autograd with dynamic shapes.
* The fake kernel gives the CPU kernel's shape, type and strides (the
  output in channels_last memory, as the CUDA kernel writes it), for an
  input in channels_last memory and for one in NCHW memory; the CPU
  kernel's values are the plain version's, bit for bit.
* The CUDA kernel launches or raises: given CPU tensors it raises
  ``ValueError`` and counts nothing, and it never runs the plain version.
* ``torch.export`` of a wrapper's first call builds its index and
  constant tensors on fake tensors: the caches keep none of them, and
  the eager wrappers still work afterwards; a cached tensor is held by a
  trace as a constant.

No JAX here: ``tests/test_torch_viz_serving.py`` holds the artifacts of
the kernel flags against the eager forward and against JAX.
"""

import numpy as np
import pytest
import torch

from simclr_tpu_torch.ops.kernels import bottleneck, conv64, registry, winograd

BF = torch.bfloat16
CL = torch.channels_last
OPS = ("bottleneck_fwd", "conv_c64", "winograd_fwd")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's thread pool costs more than it gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


def _cases(memory_format=CL):
    """name -> (the operator's CPU arguments, its plain version on them,
    its CUDA kernel, the wrapper that counts its launches). x is made in
    ``memory_format``."""
    rng = np.random.default_rng(0)

    def x(n, c, h, w):
        return _rand(rng, n, c, h, w, dtype=BF).contiguous(
            memory_format=memory_format)

    xc, wc = x(2, 64, 3, 4), _rand(rng, 64, 64, 3, 3, dtype=BF)
    xw = x(2, 32, 4, 6)
    u = winograd.transform_filter(_rand(rng, 64, 32, 3, 3)).to(BF)
    xb = x(2, 256, 3, 4)
    ws = [_rand(rng, *s) * 0.1 for s in bottleneck.weight_shapes(64)]
    aff = [_rand(rng, n) * 0.5 + (i % 2 == 0)
           for i, n in enumerate(bottleneck.affine_sizes(64))]
    packed = bottleneck.forward_half(xb, *ws)
    return {
        "conv_c64": ((xc, wc), conv64.conv3x3_c64_plain(xc, wc),
                     conv64.conv_c64_cuda, conv64.conv_c64),
        "winograd_fwd": ((xw, u), winograd.winograd_fwd_plain(xw, u),
                         winograd.winograd_fwd_cuda, winograd.winograd_fwd),
        "bottleneck_fwd": (
            (xb, *ws, bottleneck.pack_affines(aff, 64), packed),
            bottleneck.fused_bottleneck_plain(xb, *ws, aff),
            bottleneck.bottleneck_fwd_cuda, bottleneck.bottleneck_fwd),
    }


@pytest.mark.parametrize("name", OPS)
def test_opcheck_passes_on_the_cpu(name):
    args = _cases()[name][0]
    torch.library.opcheck(getattr(registry, name), args)


@pytest.mark.parametrize("memory_format", [CL, torch.contiguous_format],
                         ids=["channels_last", "nchw"])
@pytest.mark.parametrize("name", OPS)
def test_fake_kernel_matches_the_cpu_kernel(name, memory_format):
    args, plain, _, _ = _cases(memory_format)[name]
    op = getattr(torch.ops.simclr_tpu_torch, name).default
    got = op(*args)
    # Meta tensors dispatch to the fake kernel.
    fake = op(*(a.to("meta") for a in args))
    assert got.shape == plain.shape == fake.shape
    assert got.dtype == fake.dtype == BF
    assert got.stride() == fake.stride()
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("name", OPS)
def test_the_cuda_kernel_raises_on_cpu_tensors_uncounted(name):
    args, _, cuda, wrapper = _cases()[name]
    before = wrapper.launches
    with pytest.raises(ValueError, match="kernel for device cpu"):
        cuda(*args)
    assert wrapper.launches == before


def test_a_trace_keeps_no_fake_tensor_in_the_kernel_caches():
    """B5f's filter transform and B6f's packing run outside the operators,
    so ``torch.export`` traces them: a first call inside the trace must
    leave the caches empty (a ``functools.cache`` there keeps a fake
    tensor, and every later eager call fails on it)."""
    rng = np.random.default_rng(1)
    ws = [torch.nn.Parameter(_rand(rng, *s))
          for s in bottleneck.weight_shapes(64)]

    class Transforms(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ws = torch.nn.ParameterList(ws)

        def forward(self, x):
            u = winograd.transform_filter(self.ws[1])
            packed = bottleneck.pack_weights(*self.ws, False)
            return x + u.sum() + packed.float().sum()

    def constants(program):
        return sum(1 for n in program.graph.nodes if n.op == "placeholder"
                   and n.name.startswith("c_"))

    def aranges(program):
        return sum(1 for n in program.graph.nodes
                   if n.target is torch.ops.aten.arange.default)

    winograd._gmat.cache_clear()
    bottleneck._pack_index.cache_clear()
    cold = torch.export.export(Transforms(), (torch.zeros(2),), strict=False)
    # Nothing was kept: the eager calls build real tensors and keep them.
    g = winograd._gmat(torch.device("cpu"))
    assert type(g) is torch.Tensor and winograd._gmat(torch.device("cpu")) is g
    want = Transforms()(torch.zeros(2))
    assert torch.equal(cold.module()(torch.zeros(2)), want)
    # The cold trace built the packing index in its graph; a warm one
    # holds G and the index as constants.
    warm = torch.export.export(Transforms(), (torch.zeros(2),), strict=False)
    assert aranges(cold) > 0 and aranges(warm) == 0
    assert constants(warm) == 2
    assert torch.equal(warm.module()(torch.zeros(2)), want)
