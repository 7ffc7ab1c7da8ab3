"""Set-up seconds: from the process's start to the window's, loading, building at
a first run, making the inputs and warming up (host clock)."""


def read(run):
    return run.setup_s
