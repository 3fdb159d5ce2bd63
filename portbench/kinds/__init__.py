"""One cell runner per kind of traffic, found by the ``kind`` of a traffic file."""
