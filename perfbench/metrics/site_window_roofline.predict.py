"""site_window_roofline.predict: the least time of a request's masked
block-site convs wider than 1×1 (ResNet-18's three 3×3 stride-2
``convbn1``s; ``perfbench.work_blocks.site_conv_bound_s`` over the
``site`` shapes with ``k`` > 1) over the device time a traced request of
the program's windowed masked-conv kernel, ``conv_mma_kernel<…>`` (not
the 1×1 routine ``conv_mma_kernel_1x1<…>``), in percent."""

# the windowed routine's name as the trace gives it, template brackets
# included: the 1x1 routine's name continues with "_1x1<"
WINDOW_KERNEL = "conv_mma_kernel<"


def is_window_kernel(name: str) -> bool:
    return WINDOW_KERNEL in name


def read(run):
    from perfbench import work_blocks

    r = run.record
    if r.kind != "predict" or r.trace is None:
        return None
    windows = [s for s in run.shapes if s.get("site") and s["k"] > 1]
    secs, count = r.trace.kernel_time(is_window_kernel)
    if not windows or count == 0 or secs <= 0:
        return None
    bound = sum(work_blocks.site_conv_bound_s(s, r.batch, r.samples,
                                              run.cell.compute)
                for s in windows)
    return 100.0 * bound * r.trace.units / secs
