"""Peak device memory allocated during the window's steps, in GiB."""


def read(run):
    if run.kind != "train" or not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
