"""site_convs_roofline.predict: the least time of a request's masked
block-site convs (``perfbench.work_blocks.site_convs_bound_s``) over the
device time of the program's masked-conv kernels a traced request, in
percent."""


def read(run):
    from perfbench import work_blocks

    r = run.record
    if r.kind != "predict" or r.trace is None:
        return None
    secs, count = r.trace.kernel_time(work_blocks.is_site_kernel)
    if count == 0 or secs <= 0:
        return None
    bound = work_blocks.site_convs_bound_s(run.shapes, r.batch, r.samples,
                                           run.cell.compute)
    return 100.0 * bound * r.trace.units / secs
