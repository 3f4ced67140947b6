"""Mean host milliseconds of the entry call over every batch of the traced
window: from the call until it returns, before the read-back."""


def read(run):
    if not run.entry_host_s:
        return None
    return 1e3 * sum(run.entry_host_s) / len(run.entry_host_s)
