"""ms a frame of the stage pass's ``extract`` stage (a synchronize around
it, the median over the frames after the first)."""


def read(record):
    return record.get("stages", {}).get("extract")
