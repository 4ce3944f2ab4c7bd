"""``setup_s``: process start to the window's start: imports, the kernels'
build or load, the draw of the start state and one warm job."""


def read(window):
    return window["setup_s"]
