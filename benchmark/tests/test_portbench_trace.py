"""Reading a device timeline: kernel names as the metric files map them,
busy seconds as a union of intervals, idle gaps named by the harness's
spans."""

from benchmark import devtrace
from benchmark.devtrace import DeviceEvent


def test_kernel_names():
    names = {
        "void (anonymous namespace)::attention_bf16_kernel<2, false>(CUtensorMap, int)":
            "attention_bf16_kernel",
        "(anonymous namespace)::ln_rows_kernel(__nv_bfloat16 const*, float const*)":
            "ln_rows_kernel",
        "void (anonymous namespace)::grouped_kernel<0, 4>(CUtensorMap, int const*)":
            "grouped_kernel",
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl<>>(int, F)":
            "elementwise_kernel",
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT": "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT",
        "Memcpy HtoD (Pinned -> Device)": "HtoD",
    }
    for raw, want in names.items():
        assert devtrace.kernel_name(raw) == want, raw


def test_busy_and_gaps():
    ev = [DeviceEvent("void a(int)", 0, 10), DeviceEvent("void b(int)", 5, 20),
          DeviceEvent("void c(int)", 30, 40), DeviceEvent("void d(int)", 100, 101)]
    assert devtrace.busy_ns(ev) == 20 + 10 + 1
    spans = [("extract", -5, 200), ("encode", 35, 90)]
    gaps = devtrace.idle_gaps(ev, spans, offset_ns=0)
    assert gaps == [["host in encode", 60e-9], ["host in extract", 10e-9]]
    assert devtrace.idle_gaps(ev, spans, offset_ns=None)[0] == ["after c", 60e-9]
    assert devtrace.by_kernel(ev)["b"] == (1, 15e-9)
