"""setup_s: seconds from process start to the window's first timed
sample (imports, the card's context, kernel loads or builds, the
self-test, the scene, the warm-up), by the host clock."""


def read(rec):
    return rec.setup_s
