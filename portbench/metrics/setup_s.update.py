"""The set-up seconds of the cell's codec's ``Codec.update`` before the
traced stretch: the tables, generated and checked on the card
(``setup.update``)."""

from portbench import program_spans


def read(obs):
    return program_spans.setup_s(obs, "setup.update")
