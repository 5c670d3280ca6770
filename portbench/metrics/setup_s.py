"""Process start to the first timed request or step: imports, the kernel
library, weights made on the device, the traffic's audio, the warm-up."""


def read(t):
    return t.get("setup_s")
