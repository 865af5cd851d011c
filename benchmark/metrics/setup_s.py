"""Process start to the first timed frame, image or step: imports, the
device, seeded weights and inputs, the program's build and table bakes,
kernel builds and the warm-up."""


def read(rec):
    return rec["setup_s"]
