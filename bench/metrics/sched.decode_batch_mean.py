"""Mean number of requests in a decode dispatch over the window."""


def read(ctx):
    sizes = [len(step) for _, step in ctx["decodes"]]
    return sum(sizes) / len(sizes) if sizes else None
