"""Model FLOPs over the dense bf16 peak (%), in the search cells (moves
images_per_s): the FLOPs of a unit of work (a fitness call, a request;
the plain reference's, by FlopCounterMode, the guidance's input gradient
included) times the units the window ran outside the trace, over their
host seconds times the peak."""

from benchmark.roofline.count import peaks


def read(r):
    u = r["units"]
    if not u["untraced"]:
        return None
    flops = sum(r["flops_per_image"][k] * n
                for k, n in r["images"].items() if n) / u["traced"]
    return (100.0 * flops * u["untraced"]
            / (u["untraced_s"] * peaks()["bf16_flops_per_s"]))
