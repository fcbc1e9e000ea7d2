"""Host utilities the WAL needs (the port's own copies): the ENOSPC
error, durable fsync helpers and the WAL's failpoints."""
