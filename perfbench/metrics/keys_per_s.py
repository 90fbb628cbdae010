"""Keys the program completed in the window (each key of a completed batch
once; padding not counted) over the window's seconds, host clock."""


def read(view):
    return view.window.keys / view.window.seconds
