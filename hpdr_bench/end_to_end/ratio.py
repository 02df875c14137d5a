"""All field bytes compressed in the window over all the stored bytes it produced."""


def read(window):
    calls = window.of("compress")
    stored = sum(c.stored_bytes for c in calls)
    return sum(c.field_bytes for c in calls) / stored if stored else None
