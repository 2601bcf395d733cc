"""A stand-in for `utils.graphs.GraphSet.capture` on the CPU, for the tests
of the compiled callables' call paths (their keys, the copy-in, the draws
made before a replay, the donated buffers) where no card can capture.

`install(monkeypatch, *modules)` makes `on_card` true for CPU tensors (in
utils.graphs, whose `require_cuda` reads it, and in each module given that
imported it by name) and turns each capture into a `Graph` whose
`replay()` runs the body again and copies its result into the outputs of
the capture's own run; the launch counts move as a real capture's and
replay's do. A real capture records the body without running
it; the stand-in runs it once, which writes the static buffers, and
`GraphSet.run` copies the caller's state into those buffers after a
capture, so that run leaves no trace in the results.
"""
import torch

from hidegs_tpu_torch.utils import graphs


def _copy_out(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_out(dst[k], src[k])
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        graphs.copy_into(dst, src)


class _Replayed:
    def __init__(self, body, outputs):
        self.body, self.outputs = body, outputs

    def replay(self):
        counts = graphs._kernel_counts()
        _copy_out(self.outputs, self.body())
        graphs._set_kernel_counts(counts)  # a replay counts in REPLAY_LAUNCHES


def _capture(self, dev, warmup, body, info, capture_error_mode="global"):
    counts = graphs._kernel_counts()
    warmup()
    warmup_launches = dict(zip(graphs.ALL_KERNELS, (b - a for a, b in zip(counts, graphs._kernel_counts()))))
    counts = graphs._kernel_counts()
    outputs = body()
    recorded = dict(zip(graphs.ALL_KERNELS, (b - a for a, b in zip(counts, graphs._kernel_counts()))))
    graphs._set_kernel_counts(counts)
    self.captures.append(dict(info, what=self.what, warmup_s=0.0, capture_s=0.0, warmup_launches=warmup_launches,
                              launches=recorded, pool_reserved_bytes=0))
    return graphs.Graph(graph=_Replayed(body, outputs), outputs=outputs, launches=recorded)


def install(monkeypatch, *modules):
    def on_card(dev):
        return True

    monkeypatch.setattr(graphs.GraphSet, "capture", _capture)
    for m in (graphs,) + modules:
        monkeypatch.setattr(m, "on_card", on_card)
