"""From the first statement of the run to the first timed batch: imports,
the card's set-up, loading (the first run of a checkout: building) the
program's libraries, making the keys, the fill and the warm-up."""


def read(view):
    return view.setup_s
