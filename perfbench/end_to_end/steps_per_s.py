"""``steps_per_s``: every simulated step of the window's jobs over the
window's wall seconds (host clock, each job fenced by a device
synchronize): a fixed job's time to solution, inverted."""


def read(window):
    return window["steps"] / window["seconds"]
