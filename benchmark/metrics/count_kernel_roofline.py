"""count_kernel_roofline (kernels): the least time the window's count
waves allow (``benchkit.roofline``) over the count kernel's device time
(profiler kernel events; where CUPTI dropped some, their mean times the
launches), in percent."""

KERNEL = "count_blob_kernel"


def read(run):
    if KERNEL not in run.roofline:
        return None
    least, took = run.roofline[KERNEL]
    return 100.0 * least / took
