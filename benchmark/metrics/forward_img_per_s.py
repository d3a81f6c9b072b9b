"""forward_img_per_s: images through the eval forward in the window
over the window's seconds."""


def read(run):
    return run.images() / run.window_s if run.calls else None
