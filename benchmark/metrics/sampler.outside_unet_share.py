"""% of device busy time outside the UNet's and the features' ranges: the
classifier's forward and gradient and the DDIM update, in the guided
search cell (moves images_per_s)."""


def read(r):
    if not r.get("classifier", {}).get("calls"):
        return None
    inside = (r["range_device_s"]["bench.unet"]
              + r["range_device_s"]["bench.features"])
    return 100.0 * (1.0 - inside / r["busy_s"])
