"""Native (C++) components of the port, built with g++ at first use."""
