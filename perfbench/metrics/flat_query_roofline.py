"""The least time of the traced flat_query calls (their bytes and operations
over the card's peaks, counted from the inputs by the reference) as a share
of the device time of every operation those calls launched."""


def read(view):
    return view.roofline("flat_query")
