"""K4's share of its roofline: the least time the card needs for the
window's device probes (``roofline.probe_bytes`` at the card's published
HBM rate) over the device time of the kernels named ``probe_phased*`` in
the traced window.  None without a trace, a K4 kernel in it, or the
card's peak."""

from portbench import roofline

UNIT = '%'


def read(ctx):
    if ctx.trace is None:
        return None
    k4_s = sum(s for name, s in ctx.trace.kernel_s.items()
               if 'probe_phased' in name)
    peak = roofline.peak(ctx.device_name, 'hbm_bytes_per_s')
    if k4_s <= 0 or peak is None or ctx.probe_bytes == 0:
        return None
    return 100.0 * ctx.probe_bytes / peak / k4_s
