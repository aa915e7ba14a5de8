"""No kernel is built for the reference: every wrapper takes its plain
version."""


def lib():
    raise RuntimeError("the reference launches no hand kernel")


def check(status, what):
    raise RuntimeError(f"the reference launches no hand kernel ({what})")
