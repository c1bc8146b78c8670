"""Location Voting (§4.7): each long read's winning read-start diagonal."""
