"""What a configuration builds from its seed (`systems/<name>.py`,
named by the configuration file's `system` key): the inputs, the work
the harness reckons for the roofline, and the comparison that decides
`correct`."""
