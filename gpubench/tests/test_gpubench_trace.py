"""The trace reader on a made-up chrome trace."""

import pytest

from gpubench import trace


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


TRACE = {"traceEvents": [
    ev(trace.WINDOW, "user_annotation", 0, 100),
    ev("gpubench.call", "user_annotation", 0, 90),
    ev("aten::cudnn_convolution", "cpu_op", 5, 5, **{"External id": 1}),
    ev("aten::mul", "cpu_op", 40, 5, **{"External id": 2}),
    ev("cudaLaunchKernel", "cuda_runtime", 60, 2),
    ev("void cutlass__5x_cudnn::Kernel<foo>(bar)", "kernel", 10, 20,
       **{"External id": 1}),
    ev("void at::native::vectorized_elementwise_kernel<4, f>(int)",
       "kernel", 50, 10, **{"External id": 2}),
    ev("fused_crop_mirror_normalize_kernel<bf16, true, true>", "kernel",
       70, 10),
    ev("Memcpy HtoD", "gpu_memcpy", 75, 10),
    ev("outside", "kernel", 150, 10),
]}


def test_busy_idle_and_classes():
    w = trace.Window(TRACE)
    assert w.window_s == pytest.approx(100e-6)
    assert w.busy_s == pytest.approx(45e-6)
    assert w.seconds_by("class") == pytest.approx(
        {"library": 20e-6, "eager": 10e-6, "handwritten": 10e-6,
         "copy": 10e-6})
    assert w.kernel_names("library") == [
        "void cutlass__5x_cudnn::Kernel<foo>(bar)"]


def test_idle_gaps_go_to_the_innermost_host_event():
    gaps = trace.Window(TRACE).idle_gaps()
    assert gaps == pytest.approx({"aten::cudnn_convolution": 10e-6,
                                  "aten::mul": 20e-6,
                                  "gpubench.call": 10e-6,
                                  trace.WINDOW: 15e-6})


def test_kernel_group_strips_templates_namespaces_and_digits():
    assert trace.kernel_group(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "Foo<float> >(int, Bar)") == "vectorized_elementwise_kernel"
    assert trace.kernel_group("_ZN2at6native13reduce_kernelILi512EEEvv") \
        == "reduce_kernel"
