"""The RoIAlign forward kernel's share of its roofline in the train step:
the least time its work needs on each traced step's own maps and boxes (the
larger of the distinct map cells, boxes, levels and output over HBM
bandwidth and its float32 operations over peak), summed, over the kernel's
traced time, summed, in %."""

from hoibench.roofline import roi_align_share, roi_forward_bound_s


def read(ctx):
    return roi_align_share(ctx, "roi_align_staged_kernel", roi_forward_bound_s)
