"""Host seconds of the program's constructor (parse and GF translation)."""


def read(run):
    return run.spans.get("translate_s")
